"""PNG codec: the port's copy of zpix_tpu.codecs.png.

Full decode matrix: gray 1/2/4/8/16, gray+alpha 8/16, truecolor 8/16,
truecolor+alpha 8/16, paletted 1/2/4/8, tRNS for all, Adam7 interlacing,
all 5 filters, CRC verification (the reference's src/png/).
"""

from .decode import decode, decode_config, probe_buffer
from .sng import sng

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def probe_path(path: str) -> bool:
    with open(path, "rb") as f:
        return probe_buffer(f.read(8))


def load(path: str):
    with open(path, "rb") as f:
        return decode(f.read())


__all__ = ["decode", "decode_config", "probe_buffer", "probe_path", "load", "sng", "SIGNATURE"]
