"""SNG golden-output serializer, the PNG test oracle: a copy of
zpix_tpu/codecs/png/sng.py.

A port of the reference's src/png/sng.zig:48-320, with its fake
IHDR/gAMA/bKGD compensation maps for metadata the array image model drops.
Its output matches the pngsuite ``.sng`` goldens line for line (modulo the
colour-name normalization of the reference's test harness,
src/png/decoder_test.zig:101-116).  Host only.
"""

from __future__ import annotations

import os

from ...image import (
    GrayImage,
    Gray16Image,
    NRGBAImage,
    NRGBA64Image,
    PalettedImage,
    RGBAImage,
    RGBA64Image,
)
from ...image.model import PALETTE_NRGBA

FAKE_IHDR_USINGS = {
    "ftbbn0g01": "    using grayscale;\n",
    "ftbbn0g02": "    using grayscale;\n",
    "ftbbn0g04": "    using grayscale;\n",
    "ftbbn2c16": "    using color;\n",
    "ftbgn2c16": "    using color;\n",
    "ftbrn2c08": "    using color;\n",
    "ftbwn0g16": "    using grayscale;\n",
}

FAKE_GAMAS = {
    "ftbbn0g01": "",
    "ftbbn0g02": "gAMA {0.45455}\n",
}

FAKE_BKGDS = {
    "ftbbn0g01": "bKGD {gray: 0;}\n",
    "ftbbn0g02": "bKGD {gray: 0;}\n",
    "ftbbn0g04": "bKGD {gray: 0;}\n",
    "ftbbn2c16": "bKGD {red: 0;  green: 0;  blue: 65535;}\n",
    "ftbbn3p08": "bKGD {index: 245}\n",
    "ftbgn2c16": "bKGD {red: 0;  green: 65535;  blue: 0;}\n",
    "ftbgn3p08": "bKGD {index: 245}\n",
    "ftbrn2c08": "bKGD {red: 255;  green: 0;  blue: 0;}\n",
    "ftbwn0g16": "bKGD {gray: 65535;}\n",
    "ftbwn3p08": "bKGD {index: 0}\n",
    "ftbyn3p08": "bKGD {index: 245}\n",
}

_GRAY_NRGBA_STEMS = ("ftbbn0g01", "ftbbn0g02", "ftbbn0g04")


def sng(filename: str, img) -> str:
    out = []
    w, h = img.width, img.height

    if isinstance(img, (RGBAImage, NRGBAImage, GrayImage)):
        bit_depth = 8
    elif isinstance(img, PalettedImage):
        n = len(img.palette)
        if n <= 2:
            bit_depth = 1
        elif n <= 4:
            bit_depth = 2
        elif n <= 16:
            bit_depth = 4
        else:
            bit_depth = 8
    else:
        bit_depth = 16

    basename = os.path.basename(filename)
    stem = os.path.splitext(basename)[0]
    out.append(f"#SNG: from {basename}\nIHDR {{\n")
    out.append(f"    width: {w}; height: {h}; bitdepth: {bit_depth};\n")

    if stem in FAKE_IHDR_USINGS:
        out.append(FAKE_IHDR_USINGS[stem])
    elif isinstance(img, (GrayImage, Gray16Image)):
        out.append("    using grayscale;\n")
    elif isinstance(img, (RGBAImage, RGBA64Image)):
        out.append("    using color;\n")
    elif isinstance(img, (NRGBAImage, NRGBA64Image)):
        out.append("    using color alpha;\n")
    elif isinstance(img, PalettedImage):
        out.append("    using color palette;\n")
    else:
        out.append("unknown PNG decoder color model\n")

    out.append("}\n")
    out.append(FAKE_GAMAS.get(stem, "gAMA {1.0000}\n"))

    use_transparent = False
    if isinstance(img, PalettedImage):
        out.append("PLTE {\n")
        last_alpha = None
        for i, (entry, kind) in enumerate(zip(img.palette, img.palette_kinds)):
            r, g, b, a = (int(v) for v in entry)
            if kind != PALETTE_NRGBA:
                a = 0xFF
            if a != 0xFF:
                last_alpha = i
            out.append(
                f"    ({r:3d},{g:3d},{b:3d})     # rgb = (0x{r:02x},0x{g:02x},0x{b:02x})\n"
            )
        out.append("}\n")
        if stem in FAKE_BKGDS:
            out.append(FAKE_BKGDS[stem])
        if last_alpha is not None:
            out.append("tRNS {\n")
            for i in range(last_alpha + 1):
                a = int(img.palette[i, 3]) if img.palette_kinds[i] == PALETTE_NRGBA else 0xFF
                out.append(f" {a}")
            out.append("}\n")
    elif stem.startswith("ft"):
        if stem in FAKE_BKGDS:
            out.append(FAKE_BKGDS[stem])
        # Fake a tRNS chunk from the top-left pixel (sng.zig:160-197).
        if isinstance(img, NRGBAImage):
            r, g, b, a = (int(v) for v in img.pix[0, 0])
            if a == 0:
                use_transparent = True
                out.append("tRNS {\n")
                if stem in _GRAY_NRGBA_STEMS:
                    out.append(f"    gray: {r};\n")
                else:
                    out.append(f"    red: {r}; green: {g}; blue: {b};\n")
                out.append("}\n")
        elif isinstance(img, NRGBA64Image):
            r, g, b, a = (int(v) for v in img.pix[0, 0])
            if a == 0:
                use_transparent = True
                out.append("tRNS {\n")
                if stem == "ftbwn0g16":
                    out.append(f"    gray: {r};\n")
                else:
                    out.append(f"    red: {r}; green: {g}; blue: {b};\n")
                out.append("}\n")

    out.append("IMAGE {\n    pixels hex\n")

    for y in range(h):
        line = []
        if isinstance(img, GrayImage):
            line = [f"{v:02x}" for v in img.pix[y]]
        elif isinstance(img, Gray16Image):
            line = [f"{v:04x} " for v in img.pix[y]]
        elif isinstance(img, RGBAImage):
            line = [f"{p[0]:02x}{p[1]:02x}{p[2]:02x} " for p in img.pix[y]]
        elif isinstance(img, RGBA64Image):
            line = [f"{p[0]:04x}{p[1]:04x}{p[2]:04x} " for p in img.pix[y]]
        elif isinstance(img, NRGBAImage):
            if stem in _GRAY_NRGBA_STEMS:
                line = [f"{p[0]:02x}" for p in img.pix[y]]
            elif use_transparent:
                line = [f"{p[0]:02x}{p[1]:02x}{p[2]:02x} " for p in img.pix[y]]
            else:
                line = [
                    f"{p[0]:02x}{p[1]:02x}{p[2]:02x}{p[3]:02x} " for p in img.pix[y]
                ]
        elif isinstance(img, NRGBA64Image):
            if stem == "ftbwn0g16":
                line = [f"{p[0]:04x} " for p in img.pix[y]]
            elif use_transparent:
                line = [f"{p[0]:04x}{p[1]:04x}{p[2]:04x} " for p in img.pix[y]]
            else:
                line = [
                    f"{p[0]:04x}{p[1]:04x}{p[2]:04x}{p[3]:04x} " for p in img.pix[y]
                ]
        elif isinstance(img, PalettedImage):
            b_acc = 0
            c = 0
            per = 8 // bit_depth
            for x in range(w):
                b_acc = (b_acc << bit_depth) | int(img.pix[y, x])
                c += 1
                if c == per:
                    line.append(f"{b_acc:02x}")
                    b_acc = 0
                    c = 0
            if c != 0:
                while c != per:
                    b_acc <<= bit_depth
                    c += 1
                line.append(f"{b_acc:02x}")
        out.append("".join(line))
        out.append("\n")
    out.append("}\n")
    return "".join(out)
