"""Array-native image model (the port's copy of zpix_tpu/image).

The reference models images as a tagged union over nine pointer-backed pixel
buffer structs (zpix src/image/image.zig:24-131).  Here every
image *is* a dense numpy array plus a small metadata record — the layout
a batched pipeline wants (batched planes, no per-pixel accessors on the hot
path).  ``rgba_pixels`` is the universal vectorized flatten used by the
cross-codec parity tests and the QOI encoder, mirroring
``Image.rgbaPixels`` (zpix src/image/image.zig:103-130).
"""

from .geometry import Point, Rectangle
from .model import (
    Config,
    GrayImage,
    Gray16Image,
    RGBAImage,
    RGBA64Image,
    NRGBAImage,
    NRGBA64Image,
    CMYKImage,
    YCbCrImage,
    PalettedImage,
    YCbCrSubsample,
    pixel_buffer_length,
)
from .draw import Drawer
from . import util

__all__ = [
    "Point",
    "Rectangle",
    "Config",
    "GrayImage",
    "Gray16Image",
    "RGBAImage",
    "RGBA64Image",
    "NRGBAImage",
    "NRGBA64Image",
    "CMYKImage",
    "YCbCrImage",
    "PalettedImage",
    "YCbCrSubsample",
    "Drawer",
    "util",
    "pixel_buffer_length",
]
