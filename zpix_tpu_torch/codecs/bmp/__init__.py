"""BMP codec: the port's copy of zpix_tpu.codecs.bmp, and a numpy BMP
writer in the module ``encode`` (the inputs of tests and measurements).

1/2/4/8-bit paletted, 24-bit RGB, 32-bit BGRA; BITMAPINFO/V4/V5 headers;
top-down and bottom-up rows (the reference's src/bmp/decoder.zig).
"""

from .decode import decode, decode_config, probe_buffer


def probe_path(path: str) -> bool:
    with open(path, "rb") as f:
        return probe_buffer(f.read(2))


def load(path: str):
    with open(path, "rb") as f:
        return decode(f.read())


__all__ = ["decode", "decode_config", "probe_buffer", "probe_path", "load"]
