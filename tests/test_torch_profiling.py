"""zpix_tpu_torch.utils.profiling: the decoders' counters and timers against
the JAX package's on the same batch (the same counter values, megapixels
to 1e-9, the same timer names), Metrics alone (counts from many threads,
the report's format) and profile_trace on the CPU."""

import glob
import json
import threading

import numpy as np
import pytest
import torch
from _torch_jpeg import jax_native_lib, synth_jpeg, synth_plain_jpeg
from _torch_png import encode_png, random_pixels
from _torch_raster import qoi_enc, qoi_images

from zpix_tpu.parallel import batch as jb
from zpix_tpu.parallel import device_entropy as jde
from zpix_tpu.parallel import device_entropy_sync as jds
from zpix_tpu.parallel import png_batch as jpb
from zpix_tpu.parallel import qoi_batch as jq
from zpix_tpu.utils import metrics as jax_metrics
from zpix_tpu_torch import (BatchJpegDecoder, BatchPngDecoder, DeviceJpegDecoder,
                            HostIndexJpegDecoder, HostIndexQoiDecoder, SyncJpegDecoder)
from zpix_tpu_torch.utils import Metrics, metrics, profile_trace, trace


def _png_batch():
    rng = np.random.default_rng(5)
    return [encode_png(random_pixels(rng, "tc8", 24, 16), "tc8", seed=i) for i in range(2)]


# decoder -> (zpix_tpu's decoder, the port's on the CPU, the batch)
CASES = {
    "jpeg_onchip": (lambda: jde.DeviceJpegDecoder(), lambda: DeviceJpegDecoder(device="cpu"),
                    lambda: [synth_jpeg(32, 16, phase=p) for p in (0.0, 1.0)]),
    "jpeg_hostindex": (lambda: jde.HostIndexJpegDecoder(),
                       lambda: HostIndexJpegDecoder(device="cpu"),
                       lambda: [synth_plain_jpeg(32, 16, phase=p) for p in (0.0, 1.0)]),
    "jpeg_sync": (lambda: jds.SyncJpegDecoder(), lambda: SyncJpegDecoder(device="cpu"),
                  lambda: [synth_plain_jpeg(32, 16, phase=p) for p in (0.0, 1.0)]),
    "jpeg_batch": (lambda: jb.BatchJpegDecoder(), lambda: BatchJpegDecoder(device="cpu"),
                   lambda: [synth_plain_jpeg(40, 24, phase=p) for p in (0.0, 1.0)]),
    "qoi_hostindex": (lambda: jq.HostIndexQoiDecoder(), lambda: HostIndexQoiDecoder(device="cpu"),
                      lambda: [qoi_enc(i) for i in qoi_images()]),
    "png_batch": (lambda: jpb.BatchPngDecoder(), lambda: BatchPngDecoder(device="cpu"),
                  _png_batch),
}


def _recorded(registry, decode, datas):
    registry.reset()
    decode(datas)
    snap = registry.snapshot()
    return snap["counters"], set(snap["timers"])


@pytest.mark.parametrize("name", list(CASES))
def test_decoder_metrics_match_jax(name):
    """The same batch through the JAX decoder and its port: equal counters
    (megapixels to 1e-9) and the same timer names, each prefixed by the
    route's name."""
    jax_native_lib()
    make_jax, make_port, make_batch = CASES[name]
    datas = make_batch()
    want_c, want_t = _recorded(jax_metrics, make_jax().decode, datas)
    port = make_port()
    got_c, got_t = _recorded(metrics, port.decode, datas)
    if hasattr(port, "close"):
        port.close()
    assert got_t == want_t and want_t and all(t.startswith(name + ".") for t in got_t)
    assert set(got_c) == set(want_c) and want_c
    for k, v in want_c.items():
        assert got_c[k] == pytest.approx(v, abs=1e-9), k
    assert got_c[f"{name}.images"] == len(datas)


def test_counts_from_many_threads():
    """8 threads counting and timing at once lose no update."""
    m = Metrics()
    n = 2000

    def work():
        for _ in range(n):
            m.count("a")
            m.count("b", 0.5)
            m.add_time("t", 0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    snap = m.snapshot()
    assert snap["counters"] == {"a": 8 * n, "b": 8 * n * 0.5}
    assert snap["timers"]["t"]["calls"] == 8 * n
    assert snap["timers"]["t"]["total_s"] == pytest.approx(8 * n * 0.001)


def test_report_format_and_reset():
    m = Metrics()
    m.count("png_batch.images", 16)
    m.add_time("png_batch.inflate", 0.25)
    m.add_time("png_batch.inflate", 0.75)
    with trace("stage", m):
        pass
    lines = m.report().splitlines()
    assert lines[0] == f"{'png_batch.images':<36} {16.0:>12.3f}"
    assert lines[1] == f"{'png_batch.inflate':<36} {1000.0:>9.1f} ms (2x, 500.00 ms/call)"
    assert lines[2].startswith(f"{'stage':<36} ") and lines[2].endswith("ms/call)")
    m.reset()
    assert m.snapshot() == {"counters": {}, "timers": {}} and m.report() == ""


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        x = torch.arange(1000, dtype=torch.float32)
        (x * 2).sum()
    assert prof.events()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]
