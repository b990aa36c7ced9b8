"""Batched decoding on the card, and the router over it.

The port of zpix_tpu.parallel on one GPU: a batch decoder a codec route
(each a host prep, one upload and hand-written CUDA kernels),
``DecodePipeline`` overlapping a batch's prep with the last one's kernels,
and ``decode_mixed`` / ``load_batch``, which bucket a mixed list of
encoded images and send each bucket through its batch decoder.  Every
batch decoder whose zpix_tpu counterpart takes a mesh takes ``mesh=``
(``make_mesh``, ``batch_sharding``; parallel/mesh.py), and
``distributed`` spans processes.
"""

from .mesh import Sharded, batch_sharding, make_mesh
from .batch import BatchJpegDecoder, decode_batch_ycbcr_to_rgb
from .bmp_batch import BatchBmpDecoder
from .bucketing import close, decode_mixed, load_batch, plan_buckets
from .device_entropy import DeviceJpegDecoder, HostIndexJpegDecoder
from .device_entropy_sync import SyncJpegDecoder
from .pipeline import DecodePipeline
from .png_batch import BatchPngDecoder
from .progressive_onchip import OnchipProgressiveDecoder
from .qoi_batch import HostIndexQoiDecoder

__all__ = [
    "make_mesh",
    "batch_sharding",
    "Sharded",
    "BatchJpegDecoder",
    "BatchPngDecoder",
    "BatchBmpDecoder",
    "HostIndexQoiDecoder",
    "OnchipProgressiveDecoder",
    "DeviceJpegDecoder",
    "HostIndexJpegDecoder",
    "SyncJpegDecoder",
    "DecodePipeline",
    "decode_batch_ycbcr_to_rgb",
    "decode_mixed",
    "load_batch",
    "plan_buckets",
    "close",
]
