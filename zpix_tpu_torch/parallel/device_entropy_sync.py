"""Restart-free baseline JPEG decoded wholly on the GPU: no host index scan.

The port of zpix_tpu/parallel/device_entropy_sync.py (``prep_batch_sync``
:85, ``SyncJpegDecoder`` :505).  The host parses the headers and removes
the FF00 stuffing (numpy only, as ``prep_batch``); the card then runs:

1. K19 (ops/sync.py): each scan cut into chunks of ``chunk_bytes``,
   decoded speculatively from every MCU-slot guess, the true entry states
   found through the guesses' links, then every block's end bit assembled
   in raster order;
2. K2, the value pass, from K19's ends: one segment an image, exactly as
   ``HostIndexJpegDecoder`` runs it, whose agree check verifies each end;
3. K3 in its whole-image form;
4. K4, the back-end, interleaved [B, H, W, C] ([B, H, W] for gray), the
   layout zpix_tpu's ``_grids_graph`` gives.

``ok`` is K19's checks & K2's done, no error and agree, as zpix_tpu's
(:484-492).  Not ported, being TPU mechanics and not behaviour: the x32
bucketing of ``n_chunks`` (:149-152; here it is ceil(longest scan /
chunk_bytes), and the chunks past an image's end are empty in both
packages, so nothing changes), ``cap_hint`` (the stream buffer is
``_flat_stream``'s), and the ``k_syms``/``win_words``/``k1_syms`` knobs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from ..errors import UnsupportedError
from ..ops import entropy as _entropy
from ..ops import sync as _sync
from ..utils import metrics, span, stage
from .device_entropy import (DeviceJpegDecoder, ScanPlan, _batch_streams, _flat_stream,
                             _mcu_grid, _plan)


@dataclass
class SyncPlan(ScanPlan):
    """A restart-free batch after the host prep: one segment an image
    (``seg_bit_pos`` is each image's first bit), plus each image's end bit
    and the chunking."""

    img_bit_end: np.ndarray | None = None  # int64 [B]
    chunk_bytes: int = 32
    n_chunks: int = 0  # chunks an image (the longest scan's)
    mb: int = 0  # block ends a chunk records

    @property
    def img_bit_start(self) -> np.ndarray:
        return self.seg_bit_pos


def prep_batch_sync(datas: list[bytes], chunk_bytes: int = 32) -> SyncPlan:
    """Parse and destuff a batch of restart-free baseline JPEGs that share
    geometry and tables (else UnsupportedError; DRI > 0 too)."""
    if chunk_bytes < 1:
        raise ValueError("jpeg: chunk_bytes must be positive")
    header, streams, _ = _batch_streams(datas, restarts=False, route="jpeg_sync")
    if header[3] > 0:
        raise UnsupportedError(
            "jpeg: stream has restart markers; use DeviceJpegDecoder "
            "(restart segments are cheaper parallel boundaries)"
        )
    with span("jpeg_sync.prep.flat"):
        flat, offs = _flat_stream(streams)
    starts = np.asarray(offs, np.int64) * 8
    ends = starts + 8 * np.array([len(s) for s in streams], np.int64)
    mxx, myy = _mcu_grid(header[0])
    n_mcu = mxx * myy
    plan = _plan(header, stream=flat, seg_bit_pos=starts,
                 seg_n_mcu=np.full(len(datas), n_mcu, np.int32), seg_mcus=n_mcu, n_segs=1)
    return SyncPlan(
        **{f.name: getattr(plan, f.name) for f in fields(ScanPlan)}, img_bit_end=ends,
        chunk_bytes=chunk_bytes,
        n_chunks=max(1, -(-max(len(s) for s in streams) // chunk_bytes)),
        # a block is at least a 1-bit DC code and a 1-bit EOB, so a chunk of
        # 8 chunk_bytes bits completes at most 4 chunk_bytes of them
        mb=4 * chunk_bytes,
    )


class SyncJpegDecoder(DeviceJpegDecoder):
    """Restart-free baseline JPEG decoded on the card with no host index
    scan: K19, K2, K3 (whole image), K4.  ``decode`` returns interleaved
    pixels and ``ok``, a 0-dim bool on the decoder's device; ``ok`` False
    means the batch belongs to the host decoder.  Streams with restart
    markers raise UnsupportedError (they belong to DeviceJpegDecoder).
    ``decode`` makes no host sync."""

    _ROUTE, _TIMERS = "jpeg_sync", {"prep": "prep"}  # device_entropy_sync.py:548-550

    def __init__(self, *, chunk_bytes: int = 32, device=None):
        super().__init__(planar=False, device=device)
        self.chunk_bytes = chunk_bytes
        self.misses = None  # K19's link misses in the last entropy call (see ops/sync.py)

    def prep(self, datas: list[bytes]) -> SyncPlan:
        """The host half: headers, destuffing and the images' bit ranges."""
        with stage(self._ROUTE, "prep", self._TIMERS, images=len(datas)):
            plan = prep_batch_sync(datas, self.chunk_bytes)
        metrics.count("jpeg_sync.images", len(datas))
        return plan

    def upload(self, plan: SyncPlan):
        """Stream, starts, MCU counts, tables and end bits -> device tensors,
        in one copy."""
        with stage(self._ROUTE, "upload", self._TIMERS):
            return tuple(self._upload([plan.stream, plan.seg_bit_pos.astype(np.int32),
                                       plan.seg_n_mcu, plan.tables,
                                       plan.img_bit_end.astype(np.int32)]))

    def entropy(self, plan: SyncPlan, bufs, on_stage=None):
        """K19 + K2 + K3 -> (AC int16 [B*nblk, 64], restored DC int32
        [B*nblk], ok int32 [1]).  ``on_stage(name)`` is passed to K19 and
        called after K2 ("value_pass") and K3 ("dc_restore")."""
        stream, starts, seg_n_mcu, tables, ends = bufs
        ends_blk, okf, _entries, self.misses = _sync.sync_ends(
            stream, starts, ends, tables, chunk_bytes=plan.chunk_bytes,
            n_chunks=plan.n_chunks, bpm=plan.bpm, nblk=plan.n_mcu * plan.bpm,
            on_stage=on_stage)
        ac, dc = _entropy.value_pass(stream, starts, seg_n_mcu, tables, ends_blk, okf,
                                     bpm=plan.bpm)
        if on_stage is not None:
            on_stage("value_pass")
        dc = _entropy.dc_restore(dc, hv=plan.hv, seg_mcus=plan.seg_mcus)
        if on_stage is not None:
            on_stage("dc_restore")
        return ac, dc, okf
