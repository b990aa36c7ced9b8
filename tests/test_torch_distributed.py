"""parallel/distributed.py: several processes, one global mesh, on gloo.

The two-process test is test_distributed.py's for the port: two OS
processes rendezvous on 127.0.0.1, each with ``["cpu"] * 4`` as its
devices; each parses its ``local_shard`` of 8 JPEGs, places the
coefficients with ``host_local_batch`` and runs K6 (its plain version)
on its own shards, which must equal a single-process decode."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from zpix_tpu.parallel import distributed as jd
from zpix_tpu_torch.parallel import distributed as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path[:0] = [os.environ["ZPIX_REPO"], os.path.join(os.environ["ZPIX_REPO"], "tests")]
import numpy as np
import torch

torch.set_num_threads(1)
from _torch_jpeg_writer import synth_plain_jpeg
from zpix_tpu_torch.parallel import distributed
from zpix_tpu_torch.parallel.batch import (BatchJpegDecoder, decode_batch_ycbcr_to_rgb,
                                           parse_coefficients)

assert distributed.initialize(f"127.0.0.1:{port}", nproc, pid, timeout=120)
assert not distributed.initialize(f"127.0.0.1:{port}", nproc, pid)  # already joined
assert (distributed.process_index(), distributed.process_count()) == (pid, nproc)
mesh = distributed.global_mesh(devices=["cpu"] * 4)
assert mesh.shape == {"batch": 4 * nproc, "stripe": 1}, mesh.shape
assert [mesh.addressable((k, 0)) for k in range(4 * nproc)] == [
    k // 4 == pid for k in range(4 * nproc)]

work = [synth_plain_jpeg(w=48, h=32, mode="420", phase=0.1 * i) for i in range(8)]
local = distributed.local_shard(work)
assert local == work[4 * pid : 4 * pid + 4]
fes = [parse_coefficients(d) for d in local]
grids = [np.stack([fe.coeffs[c] for fe in fes]).astype(np.int16) for c in range(3)]
quants = [np.stack([fe.quants[c] for fe in fes]) for c in range(3)]
garrs = [distributed.host_local_batch(mesh, a) for a in grids + quants]
assert garrs[0].shape[0] == len(work) and not garrs[0].complete
try:
    garrs[0].numpy()
    raise AssertionError("gathered an array held by two processes")
except RuntimeError:
    pass
ref = BatchJpegDecoder(device="cpu").decode(work).numpy()  # the single-process decode
checked = 0
for k in range(len(garrs[0].shards)):
    rows = garrs[0].indices[k][0]
    assert all(g.indices[k][0] == rows for g in garrs)
    px = decode_batch_ycbcr_to_rgb(*[g.shards[k] for g in garrs], height=fes[0].height,
                                   width=fes[0].width, ratio=fes[0].ratio)
    assert np.array_equal(px.numpy(), ref[rows]), rows
    checked += px.shape[0]
assert checked == 4
seen = [None] * nproc
torch.distributed.all_gather_object(seen, checked)
assert seen == [4] * nproc
torch.distributed.destroy_process_group()
print(f"WORKER_{pid}_OK")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("n,pid,nproc", [(8, 0, 2), (8, 1, 2), (7, 1, 2), (7, 2, 3),
                                         (3, 2, 4), (0, 0, 1)])
def test_local_shard_matches_jax(n, pid, nproc):
    items = list(range(n))
    assert td.local_shard(items, pid, nproc) == jd.local_shard(items, pid, nproc)


def test_single_process_needs_no_group():
    assert td.initialize() is False
    assert td.initialize("127.0.0.1:1", num_processes=1, process_id=0) is False
    assert (td.process_index(), td.process_count()) == (0, 1)
    assert td.local_shard(list(range(5))) == list(range(5))
    mesh = td.global_mesh(devices=["cpu"] * 4, stripe=2)
    assert mesh.shape == {"batch": 2, "stripe": 2}
    assert all(mesh.addressable(p) for p in np.ndindex(2, 2))
    a = np.arange(4 * 3, dtype=np.int32).reshape(4, 3)
    g = td.host_local_batch(mesh, a)
    assert g.complete and g.shape == (4, 3) and np.array_equal(np.asarray(g), a)
    with pytest.raises(ValueError):
        td.host_local_batch(mesh, a[:3])


def test_two_process_distributed_decode(tmp_path):
    port = _free_port()
    env = dict(os.environ, ZPIX_REPO=REPO)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(i), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True, cwd=str(tmp_path))
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} rc={p.returncode}:\n{out[-3000:]}"
        assert f"WORKER_{i}_OK" in out, out[-3000:]
