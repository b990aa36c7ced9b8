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
"""

from . import errors
from .parallel.batch import BatchJpegDecoder
from .parallel.bmp_batch import BatchBmpDecoder
from .parallel.png_batch import BatchPngDecoder
from .parallel.device_entropy import (DeviceJpegDecoder, HostIndexJpegDecoder,
                                      prep_batch, prep_batch_host_index)
from .parallel.device_entropy_sync import SyncJpegDecoder, prep_batch_sync
from .parallel.progressive_onchip import OnchipProgressiveDecoder
from .parallel.qoi_batch import HostIndexQoiDecoder, encode_device, encode_device_batch

__all__ = ["BatchBmpDecoder", "BatchJpegDecoder", "BatchPngDecoder", "DeviceJpegDecoder",
           "HostIndexJpegDecoder", "HostIndexQoiDecoder", "OnchipProgressiveDecoder",
           "SyncJpegDecoder", "encode_device", "encode_device_batch", "prep_batch",
           "prep_batch_host_index", "prep_batch_sync", "errors"]
