"""Format codecs: jpeg, png, qoi, bmp (host decoders, the port's copies of
zpix_tpu.codecs)."""

from . import bmp, jpeg, png, qoi

__all__ = ["bmp", "jpeg", "png", "qoi"]
