"""QOI codec (decode + encode): the port's copy of zpix_tpu.codecs.qoi
(the reference's src/qoi/decoder.zig, encoder.zig, root.zig)."""

from .decode import decode, decode_config, probe_buffer
from .encode import encode, Desc

MAGIC = b"qoif"


def probe_path(path: str) -> bool:
    with open(path, "rb") as f:
        return probe_buffer(f.read(14))


def load(path: str):
    with open(path, "rb") as f:
        return decode(f.read())


__all__ = ["decode", "decode_config", "encode", "Desc", "probe_buffer", "probe_path", "load", "MAGIC"]
