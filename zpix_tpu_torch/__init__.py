"""zpix_tpu_torch — the PyTorch/CUDA port of zpix_tpu for NVIDIA Hopper.

Baseline JPEG with restart markers (``DeviceJpegDecoder``), restart-free
baseline JPEG through the host index scan (``HostIndexJpegDecoder``),
through the native coefficient front-end (``BatchJpegDecoder``) and wholly
on the card by speculative chunk sync (``SyncJpegDecoder``),
progressive JPEG (``OnchipProgressiveDecoder``, host index walks), QOI
(``HostIndexQoiDecoder``; ``encode_device``, ``encode_device_batch``), BMP
(``BatchBmpDecoder``) and PNG (``BatchPngDecoder``, three front-ends, Adam7)
run on hand-written CUDA kernels (``csrc/``),
built with nvcc on first use; the host C++ (``csrc/host``) is built with
g++.  ``BatchJpegDecoder`` also takes RGB, YCCK, CMYK, multi-scan and
progressive batches through its Python front-end, the host JPEG decoder
(``codecs.jpeg``, with ``image`` and ``color``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which takes each kernel's plain PyTorch version.

The top-level API is zpix_tpu's, on the port's host decoders: ``from_buffer``
(``decode``), ``from_file_path`` (``load``) and ``decode_config`` probe PNG,
JPEG, QOI and BMP by their magic bytes, in that order (the reference's
root.zig:24-40), and decode on the host.  ``parallel.decode_mixed``
routes a mixed list of encoded images through the batch decoders above.
The batch decoders and ``decode_mixed`` take ``mesh=`` (``parallel.make_mesh``)
to shard a batch over several devices; ``parallel.distributed`` spans
processes.
"""

from . import errors
from .codecs import bmp, jpeg, png, qoi
from .errors import UnknownFormat
from .image import (
    CMYKImage,
    Config,
    Drawer,
    GrayImage,
    Gray16Image,
    NRGBAImage,
    NRGBA64Image,
    PalettedImage,
    Point,
    Rectangle,
    RGBAImage,
    RGBA64Image,
    YCbCrImage,
    YCbCrSubsample,
)
from .parallel.batch import BatchJpegDecoder
from .parallel.bmp_batch import BatchBmpDecoder
from .parallel.png_batch import BatchPngDecoder
from .parallel.device_entropy import (DeviceJpegDecoder, HostIndexJpegDecoder,
                                      prep_batch, prep_batch_host_index)
from .parallel.device_entropy_sync import SyncJpegDecoder, prep_batch_sync
from .parallel.progressive_onchip import OnchipProgressiveDecoder
from .parallel.qoi_batch import HostIndexQoiDecoder, encode_device, encode_device_batch

__version__ = "0.1.0"

_CODECS = (png, jpeg, qoi, bmp)  # probe order (the reference's root.zig:24-40)


def from_buffer(buf: bytes):
    """Decode an image of any supported format from a byte buffer."""
    for codec in _CODECS:
        if codec.probe_buffer(buf):
            return codec.decode(buf)
    raise UnknownFormat("zpix: no codec matched the buffer")


def from_file_path(path: str):
    """Decode an image of any supported format from a file path."""
    with open(path, "rb") as f:
        return from_buffer(f.read())


# Aliases matching common Python naming.
load = from_file_path
decode = from_buffer


def decode_config(buf: bytes) -> Config:
    """Probe image metadata without a full decode."""
    for codec in _CODECS:
        if codec.probe_buffer(buf):
            return codec.decode_config(buf)
    raise UnknownFormat("zpix: no codec matched the buffer")


__all__ = ["BatchBmpDecoder", "BatchJpegDecoder", "BatchPngDecoder", "DeviceJpegDecoder",
           "HostIndexJpegDecoder", "HostIndexQoiDecoder", "OnchipProgressiveDecoder",
           "SyncJpegDecoder", "encode_device", "encode_device_batch", "prep_batch",
           "prep_batch_host_index", "prep_batch_sync", "errors", "from_buffer",
           "from_file_path", "load", "decode", "decode_config", "png", "jpeg", "qoi", "bmp",
           "Config", "Point", "Rectangle", "Drawer", "GrayImage", "Gray16Image", "RGBAImage",
           "RGBA64Image", "NRGBAImage", "NRGBA64Image", "CMYKImage", "PalettedImage",
           "YCbCrImage", "YCbCrSubsample"]
