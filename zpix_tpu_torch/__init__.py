"""zpix_tpu_torch — the PyTorch/CUDA port of zpix_tpu for NVIDIA Hopper.

Baseline JPEG with restart markers (``DeviceJpegDecoder``), restart-free
baseline JPEG through the host index scan (``HostIndexJpegDecoder``) and
through the native coefficient front-end (``BatchJpegDecoder``),
progressive JPEG (``OnchipProgressiveDecoder``, host index walks), QOI
(``HostIndexQoiDecoder``; ``encode_device``, ``encode_device_batch``) and
BMP (``BatchBmpDecoder``) run on hand-written CUDA kernels (``csrc/``),
built with nvcc on first use; the host C++ (``csrc/host``) is built with
g++.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which takes each kernel's plain PyTorch version.
"""

from . import errors
from .parallel.batch import BatchJpegDecoder
from .parallel.bmp_batch import BatchBmpDecoder
from .parallel.device_entropy import (DeviceJpegDecoder, HostIndexJpegDecoder,
                                      prep_batch, prep_batch_host_index)
from .parallel.progressive_onchip import OnchipProgressiveDecoder
from .parallel.qoi_batch import HostIndexQoiDecoder, encode_device, encode_device_batch

__all__ = ["BatchBmpDecoder", "BatchJpegDecoder", "DeviceJpegDecoder", "HostIndexJpegDecoder",
           "HostIndexQoiDecoder", "OnchipProgressiveDecoder", "encode_device",
           "encode_device_batch", "prep_batch", "prep_batch_host_index", "errors"]
