"""JPEG codec (the port's copy of zpix_tpu/codecs/jpeg: the host decoder).

Baseline + extended sequential + progressive DCT; gray, YCbCr, RGB,
CMYK/YCCK; 4:4:4/4:4:0/4:2:2/4:2:0/4:1:1/4:1:0 subsampling; restart markers
with resync; 8-bit precision.  Reference: zpix src/jpeg/.
"""

from .decoder import decode, decode_config

MAGIC = b"\xff\xd8\xff"


def probe_buffer(buf: bytes) -> bool:
    return len(buf) >= 3 and buf[:3] == MAGIC


def probe_path(path: str) -> bool:
    with open(path, "rb") as f:
        return probe_buffer(f.read(3))


def load(path: str):
    with open(path, "rb") as f:
        return decode(f.read())


__all__ = ["decode", "decode_config", "probe_buffer", "probe_path", "load", "MAGIC"]
