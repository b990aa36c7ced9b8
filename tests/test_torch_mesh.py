"""The port's mesh (parallel/mesh.py) and its mesh= decoders on the CPU.

The port runs on ``make_mesh(["cpu"] * 8)``; zpix_tpu runs on the
conftest's 8 virtual XLA:CPU devices.  Outputs (or errors) are compared at
tolerance 0: each decoder's sharded decode against zpix_tpu's same decoder
on its mesh, and against the port's unsharded decode where zpix_tpu's mesh
form is not run (the JPEG restart-lane compile is slow) or fails."""

import os

import numpy as np
import pytest
import torch
from _torch_jpeg import python_front_end_cases, synth_cmyk, synth_jpeg, synth_plain_jpeg
from _torch_png import png_batch
from _torch_raster import bmp_batch, qoi_enc, qoi_images

import zpix_tpu_torch.parallel.bucketing as tb
from zpix_tpu.parallel import bucketing as jb
from zpix_tpu.parallel import make_mesh as jax_make_mesh
from zpix_tpu.parallel.batch import BatchJpegDecoder as JaxBatchJpeg
from zpix_tpu.parallel.bmp_batch import BatchBmpDecoder as JaxBmp
from zpix_tpu.parallel.device_entropy import DeviceJpegDecoder as JaxDevice
from zpix_tpu.parallel.device_entropy import HostIndexJpegDecoder as JaxHostIndex
from zpix_tpu.parallel.device_entropy import prep_batch as jax_prep_batch
from zpix_tpu.parallel.png_batch import BatchPngDecoder as JaxPng
from zpix_tpu.parallel.qoi_batch import HostIndexQoiDecoder as JaxQoi
from zpix_tpu_torch import prep_batch
from zpix_tpu_torch.ops import sparse
from zpix_tpu_torch.parallel import (BatchBmpDecoder, BatchJpegDecoder, BatchPngDecoder,
                                     DecodePipeline, DeviceJpegDecoder, HostIndexJpegDecoder,
                                     HostIndexQoiDecoder, Sharded, batch_sharding, make_mesh)
from zpix_tpu_torch.parallel import mesh as tm


@pytest.fixture(scope="module")
def cpu8():
    return make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh()


def _equal_or_same_error(port, ref):
    """Run both; equal arrays, or the same exception class from both."""
    try:
        want = np.asarray(ref())
    except Exception as exc:  # noqa: BLE001 -- the class is what is compared
        with pytest.raises(type(exc)):
            port()
        return None
    got = port()
    assert isinstance(got, Sharded)
    arr = np.asarray(got)
    assert arr.dtype == want.dtype and np.array_equal(arr, want)
    return got


# ------------------------------------------------------------------- mesh


@pytest.mark.parametrize("batch,stripe", [(None, 1), (4, 2), (2, 4), (None, 2)])
def test_make_mesh_shape_matches_jax(batch, stripe):
    import jax

    want = jax_make_mesh(jax.devices(), batch=batch, stripe=stripe)
    got = make_mesh(["cpu"] * 8, batch=batch, stripe=stripe)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert all(d == torch.device("cpu") for d in got.devices.reshape(-1))


def test_make_mesh_errors_match_jax():
    import jax

    with pytest.raises(ValueError) as want:
        jax_make_mesh(jax.devices(), batch=3, stripe=2)
    with pytest.raises(ValueError) as got:
        make_mesh(["cpu"] * 8, batch=3, stripe=2)
    assert str(got.value) == str(want.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_default_mesh_needs_a_card():
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(["cuda:0"] * 4)
    with pytest.raises(RuntimeError):
        DeviceJpegDecoder()


@pytest.mark.parametrize("stripe_dim,shape", [(None, (8, 6, 5)), (1, (8, 6, 5)),
                                              (2, (4, 2, 6)), (None, (4, 3))])
def test_sharding_indices_match_devices_indices_map(stripe_dim, shape):
    import jax

    from zpix_tpu.parallel import batch_sharding as jax_batch_sharding

    jm = jax_make_mesh(jax.devices(), batch=4, stripe=2)
    want = jax_batch_sharding(jm, stripe_dim=stripe_dim).devices_indices_map(shape)
    got = batch_sharding(make_mesh(["cpu"] * 8, batch=4, stripe=2),
                         stripe_dim=stripe_dim).indices(shape)
    for pos in np.ndindex(4, 2):
        norm = lambda idx: tuple((s.start, s.stop) for s in idx)  # noqa: E731
        assert norm(got[pos]) == norm(want[jm.devices[pos]]), pos


def test_put_matches_device_put(jmesh, cpu8):
    import jax

    from zpix_tpu.parallel import batch_sharding as jax_batch_sharding

    a = np.arange(8 * 3 * 2, dtype=np.int32).reshape(8, 3, 2)
    got = tm.put(a, batch_sharding(cpu8))
    want = jax.device_put(a, jax_batch_sharding(jmesh))
    assert got.shape == want.shape and len(got.shards) == 8
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(got.cpu().numpy(), a) and got.devices == [torch.device("cpu")] * 8
    with pytest.raises(ValueError):
        jax.device_put(a[:6], jax_batch_sharding(jmesh))
    with pytest.raises(ValueError):
        tm.put(a[:6], batch_sharding(cpu8))


def test_sharded_stack_regroup_and_incomplete():
    parts = [torch.arange(6).view(3, 2), torch.zeros(0, 2, dtype=torch.int64),
             torch.arange(6, 10).view(2, 2)]
    s = Sharded.stack(parts)
    assert s.shape == (5, 2) and np.array_equal(np.asarray(s), np.arange(10).reshape(5, 2))
    # units of 2 an image: position 0 holds image 0 and the first unit of
    # image 1, position 2 the second unit of image 1 and image 2
    units = [torch.arange(3), torch.arange(3, 3), torch.arange(3, 6)]
    got = tm.regroup(units, 2)
    assert [n for _, n in got] == [2, 0, 1]
    assert got[0][0].tolist() == [0, 1, 2, 3] and got[2][0].tolist() == [4, 5]
    whole = [torch.arange(4), torch.arange(4, 8)]
    for (t, _), src in zip(tm.regroup(whole, 2), whole):
        assert t.data_ptr() == src.data_ptr()  # whole images: no copy
    part = Sharded([torch.zeros(2)], [(slice(0, 2),)], (4,), complete=False)
    with pytest.raises(RuntimeError):
        part.numpy()


def test_mesh_and_device_together_raise(cpu8):
    with pytest.raises(ValueError):
        BatchBmpDecoder(mesh=cpu8, device="meta")
    assert BatchBmpDecoder(mesh=cpu8, device="cpu").device == torch.device("cpu")


# ------------------------------------------------------- restart-lane JPEG


def test_device_jpeg_mesh_matches_zpix_tpu_mesh(cpu8, jmesh):
    """zpix_tpu's packed mesh decode (test_device_entropy.py's
    test_mesh_packed_decode_parity shape) against the port's."""
    datas = [synth_jpeg(w=256, h=128, dri_blocks=5)] * 8
    want, want_ok = JaxDevice(mesh=jmesh, packed=True).decode(datas)
    got, ok = DeviceJpegDecoder(mesh=cpu8).decode(datas)
    assert bool(want_ok) and ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    assert isinstance(got, Sharded) and [s.shape[0] for s in got.shards] == [1] * 8
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_device_jpeg_lane_mismatch_raises(cpu8, jmesh):
    data = synth_jpeg(w=40, h=24, dri_blocks=5)
    jplan, plan = jax_prep_batch([data]), prep_batch([data])
    assert (plan.batch * plan.n_segs) % 8
    with pytest.raises(ValueError) as want:
        JaxDevice(mesh=jmesh).decode_coefficients(jplan)
    with pytest.raises(ValueError) as got:
        DeviceJpegDecoder(mesh=cpu8).decode_coefficients(plan)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        DeviceJpegDecoder(mesh=cpu8).decode([data])


@pytest.mark.parametrize("dri,batch,n,owned", [
    (3, 6, 4, [2, 1, 2, 1]),  # 2 segments an image, 3 lanes a position
    (1, 4, 8, [1, 0, 1, 0, 1, 0, 1, 0]),  # 6 segments an image over two positions
    (2, 8, 8, [1] * 8),  # whole images: no copy between positions
], ids=["straddle", "straddle_empty_positions", "whole"])
@pytest.mark.parametrize("planar", [False, True], ids=["interleaved", "planar"])
def test_device_jpeg_straddling_images(dri, batch, n, owned, planar):
    """The mesh divides the lane count but not the batch: an image's lanes
    on two positions come together where its first lane is."""
    datas = [synth_jpeg(w=48, h=32, dri_blocks=dri, phase=0.1 * i) for i in range(batch)]
    want, want_ok = DeviceJpegDecoder(device="cpu", planar=planar).decode(datas)
    got, ok = DeviceJpegDecoder(mesh=make_mesh(["cpu"] * n), planar=planar).decode(datas)
    assert bool(want_ok) and bool(ok)
    assert [s.shape[0] for s in got.shards] == owned
    assert np.array_equal(np.asarray(got), want.numpy())
    coeffs, cok = DeviceJpegDecoder(mesh=make_mesh(["cpu"] * n)).decode_coefficients(
        prep_batch(datas))
    want_c, _ = DeviceJpegDecoder(device="cpu").decode_coefficients(prep_batch(datas))
    assert bool(cok) and np.array_equal(np.asarray(coeffs), want_c.numpy())


def test_device_jpeg_mesh_ok_is_every_shards():
    """A bad code in one image's segment clears the mesh's ok."""
    datas = [synth_jpeg(w=96, h=64, mode="420", phase=0.3, dri_blocks=2) for _ in range(4)]
    bad = bytearray(datas[3])
    mid = (bad.find(b"\xff\xda") + len(bad)) // 2
    while bad[mid - 1] == 0xFF:
        mid += 1
    bad[mid : mid + 8] = b"\xff\x00" * 4
    datas[3] = bytes(bad)
    _, want_ok = DeviceJpegDecoder(device="cpu").decode(datas)
    _, ok = DeviceJpegDecoder(mesh=make_mesh(["cpu"] * 4)).decode(datas)
    assert not bool(want_ok) and not bool(ok) and ok.dim() == 0


def test_host_index_mesh(cpu8, jmesh):
    """zpix_tpu's HostIndexJpegDecoder fails on a mesh (ROADMAP queue 3:
    its packed mesh upload meets a body built without the mesh); the
    port's shards as DeviceJpegDecoder does and equals zpix_tpu's unsharded
    decode."""
    datas = [synth_plain_jpeg(w=48, h=32, mode="420", phase=0.1 * i) for i in range(8)]
    with pytest.raises(TypeError):
        JaxHostIndex(mesh=jmesh).decode(datas)
    want, want_ok = JaxHostIndex().decode(datas)
    got, ok = HostIndexJpegDecoder(mesh=cpu8).decode(datas)
    assert bool(want_ok) and bool(ok)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError) as jerr:
        JaxHostIndex(mesh=jmesh).decode(datas[:6])
    with pytest.raises(ValueError) as terr:
        HostIndexJpegDecoder(mesh=cpu8).decode(datas[:6])
    assert str(terr.value) == str(jerr.value)


# -------------------------------------------------- image-sharded decoders


def _jpeg_inputs(kind):
    if kind == "native":
        return [synth_plain_jpeg(w=48, h=32, mode="420", phase=0.1 * i) for i in range(8)]
    return [synth_cmyk(None, w=40, h=24, seed=i, dri_blocks=None) for i in range(8)]


@pytest.mark.parametrize("batch", [8, 6])
@pytest.mark.parametrize("kind", ["native", "python_front_end"])
def test_batch_jpeg_mesh_matches_zpix_tpu(kind, batch, cpu8, jmesh):
    datas = _jpeg_inputs(kind)[:batch]
    got = _equal_or_same_error(lambda: BatchJpegDecoder(mesh=cpu8).decode(datas),
                               lambda: JaxBatchJpeg(mesh=jmesh).decode(datas))
    assert (got is None) == (batch % 8 != 0)


def test_batch_jpeg_mesh_python_front_end_arms(cpu8):
    """Every arm of the Python front-end, sharded, against the unsharded."""
    for name, make in python_front_end_cases(32, 24).items():
        datas = [make(s) for s in range(8)]
        want = BatchJpegDecoder(device="cpu").decode(datas).numpy()
        got = BatchJpegDecoder(mesh=cpu8).decode(datas)
        assert np.array_equal(np.asarray(got), want), name


@pytest.mark.parametrize("batch", [8, 6])
@pytest.mark.parametrize("arm", [(24, 40, False, False), (8, 40, False, True),
                                 (32, 124, True, False)])
def test_bmp_mesh_matches_zpix_tpu(arm, batch, cpu8, jmesh):
    datas = bmp_batch(arm, 7, 13, batch=8, seed=arm[0])[:batch]
    got = _equal_or_same_error(lambda: BatchBmpDecoder(mesh=cpu8).decode(datas),
                               lambda: JaxBmp(mesh=jmesh).decode(datas))
    assert (got is None) == (batch % 8 != 0)


PNG_FRONTS = {"host": {}, "device_defilter": {"device_defilter": True},
              "device_inflate": {"device_inflate": True}}


@pytest.mark.parametrize("batch", [8, 4])
@pytest.mark.parametrize("case", ["tc8", "p4_adam7_trns"])
@pytest.mark.parametrize("front", list(PNG_FRONTS))
def test_png_mesh_matches_zpix_tpu(front, case, batch, cpu8, jmesh):
    if case == "tc8":
        datas = png_batch("tc8", 13, 7, batch=8)[0]
    else:
        datas = png_batch("p4", 13, 7, batch=8, interlace=True, trns=True)[0]
    datas = datas[:batch]
    kw = PNG_FRONTS[front]
    got = _equal_or_same_error(lambda: BatchPngDecoder(mesh=cpu8, **kw).decode(datas),
                               lambda: JaxPng(mesh=jmesh, **kw).decode(datas))
    assert (got is None) == (batch % 8 != 0)


def test_png_mesh_flags_a_bad_filter_byte_on_any_shard(cpu8):
    """The inflate route's flag is read from every shard."""
    datas = png_batch("tc8", 13, 7, batch=8)[0]
    bad = png_batch("tc8", 13, 7, batch=1, seed=9)[0][0]
    import zlib

    from _torch_png import chunk

    idat_at = bad.find(b"IDAT") - 4
    n = int.from_bytes(bad[idat_at : idat_at + 4], "big")
    raw = bytearray(zlib.decompress(bad[idat_at + 8 : idat_at + 8 + n]))
    raw[0] = 7  # filter type 7
    datas[5] = bad[:idat_at] + chunk(b"IDAT", zlib.compress(bytes(raw))) + bad[
        idat_at + 12 + n:]
    from zpix_tpu_torch.errors import FormatError

    with pytest.raises(FormatError):
        BatchPngDecoder(device="cpu", device_inflate=True).decode(datas)
    with pytest.raises(FormatError):
        BatchPngDecoder(mesh=cpu8, device_inflate=True).decode(datas)


@pytest.mark.parametrize("batch", [8, 6, 4])
@pytest.mark.parametrize("impl", ["lane", "sorted"])
def test_qoi_mesh_matches_zpix_tpu(impl, batch, cpu8, jmesh):
    """Lane: the lanes shard (4 images of 30 lanes divide 8 positions, so
    images straddle them, and zpix_tpu decodes too); sorted: the images."""
    imgs = qoi_images(w=40, h=24)
    datas = [qoi_enc(imgs[i % 4]) for i in range(batch)]
    got = _equal_or_same_error(lambda: HostIndexQoiDecoder(mesh=cpu8, impl=impl).decode(datas),
                               lambda: JaxQoi(mesh=jmesh, impl=impl).decode(datas))
    lanes_divide = impl == "lane" and batch * 30 % 8 == 0
    assert (got is not None) == (batch % 8 == 0 or lanes_divide)


def test_qoi_lane_wide_form_mesh(cpu8):
    """Alpha content takes the wide form; images straddle positions."""
    imgs = qoi_images(w=40, h=24)
    datas = [qoi_enc(imgs[3])] * 4
    want = HostIndexQoiDecoder(device="cpu").decode(datas).numpy()
    got = HostIndexQoiDecoder(mesh=cpu8, lane_fmt="wide").decode(datas)
    assert np.array_equal(np.asarray(got), want)
    assert [s.shape[0] for s in got.shards] == [1, 0, 1, 0, 1, 0, 1, 0]


def test_pipeline_over_a_mesh_decoder(cpu8):
    batches = [[synth_jpeg(w=48, h=32, dri_blocks=3, phase=0.1 * (i + j)) for j in range(4)]
               for i in range(3)]
    dec = DeviceJpegDecoder(mesh=cpu8)
    for datas, (px, ok) in zip(batches, DecodePipeline(dec).map(batches)):
        want, _ = DeviceJpegDecoder(device="cpu").decode(datas)
        assert bool(ok) and np.array_equal(np.asarray(px), want.numpy())


# ------------------------------------------------------------- the router


def _mixed():
    """Buckets of 8 (shard), of 4 (the mesh divides QOI's lanes, not the
    BMP batch: host-error in both packages) and of 1 (host-small)."""
    imgs = qoi_images(w=20, h=12)
    out = [qoi_enc(imgs[i % 4]) for i in range(8)]
    out += [qoi_enc(imgs[i % 4]) for i in range(4)]  # 32 x 18 below: a bucket of its own
    out[8:] = [qoi_enc(np.ascontiguousarray(np.resize(imgs[i], (18, 32, 4)))) for i in range(4)]
    out += bmp_batch((24, 40, False, False), 6, 9, batch=8, seed=1)
    out += bmp_batch((8, 40, False, False), 6, 9, batch=4, seed=2)
    out += png_batch("tc8", 13, 7, batch=8)[0]
    out += [synth_plain_jpeg(w=40, h=24, phase=0.1 * i) for i in range(8)]
    out += [synth_jpeg(w=24, h=16, mode="gray")]
    rng = np.random.default_rng(0)
    return [out[i] for i in rng.permutation(len(out))]


def test_decode_mixed_mesh_matches_zpix_tpu(cpu8, jmesh, tmp_path):
    corpus = _mixed()
    want, want_stats = jb.decode_mixed(corpus, mesh=jmesh, min_batch=2, return_stats=True)
    got, got_stats = tb.decode_mixed(corpus, mesh=cpu8, min_batch=2, return_stats=True)
    assert got_stats == want_stats == {"device": 36, "host-error": 4, "host-small": 1}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), i
    plain = tb.decode_mixed(corpus, device="cpu", min_batch=2)
    assert all(np.array_equal(g, p) for g, p in zip(got, plain))
    paths = []
    for i, d in enumerate(corpus[:12]):
        paths.append(os.path.join(tmp_path, f"{i}.img"))
        with open(paths[-1], "wb") as f:
            f.write(d)
    loaded = tb.load_batch(paths, mesh=cpu8, min_batch=2)
    assert all(np.array_equal(a, b) for a, b in zip(loaded, got[:12]))


def test_router_caches_a_decoder_a_mesh(cpu8):
    try:
        a = tb.decoder("bmp", cpu8.first, cpu8)
        assert tb.decoder("bmp", cpu8.first, make_mesh(["cpu"] * 8)) is a
        assert tb.decoder("bmp", cpu8.first, make_mesh(["cpu"] * 4)) is not a
        assert tb.decoder("bmp", cpu8.first) is not a and a.mesh == cpu8
        assert tb.decoder("progressive", cpu8.first, cpu8) is tb.decoder("progressive",
                                                                         cpu8.first)
    finally:
        tb.close()


# ------------------------------------------------------------ grid maps


def test_grid_map_cache_is_bounded_and_keyed_by_device():
    from zpix_tpu_torch.parallel.batch import stream_perm

    sparse._GRID_MAPS.clear()
    geoms = [(mxx, 3, 2, 2) for mxx in range(1, 3 * sparse.GRID_MAPS_KEPT)]
    for g in geoms:
        m = sparse.grid_map(stream_perm(*g), torch.device("cpu"))
        assert m.device == torch.device("cpu")
        assert np.array_equal(m.numpy(), sparse.stream_to_grid(stream_perm(*g)))
        assert len(sparse._GRID_MAPS) <= sparse.GRID_MAPS_KEPT
    # the four ints key the same map as the perm's array
    g = geoms[-1]
    by_ints = sparse.grid_map(g, "cpu")
    assert torch.equal(by_ints, sparse.grid_map(stream_perm(*g), "cpu"))
    assert sparse.grid_map(g, "cpu") is by_ints
    assert len(sparse._GRID_MAPS) <= sparse.GRID_MAPS_KEPT
    # the most recently used stays, the least recently used goes
    first = sparse.grid_map(stream_perm(*geoms[-2]), "cpu")
    for g in geoms[: sparse.GRID_MAPS_KEPT - 1]:
        sparse.grid_map(stream_perm(*g), "cpu")
    assert sparse.grid_map(stream_perm(*geoms[-2]), "cpu") is first
    bm = torch.zeros(1, 36, 8, dtype=torch.uint8)  # a 6 x 6 grid: 3 x 3 MCUs of 2 x 2
    comp = sparse.SparseComponent(bm, torch.zeros(1, 1, dtype=torch.int16), 6, 6, (3, 3, 2, 2))
    assert sparse.unpack_components([comp])[0].shape == (1, 6, 6, 64)
    with pytest.raises(ValueError):
        sparse.unpack_components([comp._replace(perm=(3, 3, 2, 1))])
