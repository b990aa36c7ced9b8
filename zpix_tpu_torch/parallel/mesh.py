"""Device meshes and sharded batches on PyTorch devices.

The port of zpix_tpu/parallel/mesh.py.  The decode workload shards along
the mesh's ``batch`` axis: independent images (or, for restart-segment
JPEG and QOI lanes, independent lanes of the batch), each shard decoded by
the ported kernels on its own device.  The ``stripe`` axis is carried for
the mesh's shape; no decoder uses it, as in the JAX package.

Three differences from a ``jax.sharding.Mesh``, on purpose:

* ``make_mesh()`` with no devices takes every visible CUDA device and
  raises when there is none; it never falls back to a CPU mesh.
* A device may be listed more than once.  PyTorch has no virtual devices,
  so ``make_mesh(["cpu"] * 8)`` stands in for XLA's 8 forced host devices
  (the CPU tests), and ``make_mesh(["cuda:0"] * 4)`` runs four shards on
  one card (their kernels queue on the card's stream one after another).
* Sharded outputs are ``Sharded``: each shard a tensor on its own device,
  gathered to the host only by ``numpy()``, ``cpu()`` or ``np.asarray``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .device_entropy import PinnedUpload, resolve_device

AXES = ("batch", "stripe")


def _device(d) -> torch.device:
    """An explicit device: a bare ``cuda`` gets the current card's index,
    a card that is not there raises."""
    dev = resolve_device(d)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"zpix_tpu_torch: no device {dev}")
    return dev


class Mesh:
    """A [batch, stripe] grid of torch devices (``devices``, an object
    array) with ``shape == {"batch": b, "stripe": s}``.  ``processes``
    gives each position's process (all this process's by default;
    ``distributed.global_mesh`` spans several)."""

    def __init__(self, devices, processes=None):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError("mesh: devices must be a [batch, stripe] grid")
        if processes is None:
            from .distributed import process_index

            processes = np.full(self.devices.shape, process_index())
        self.processes = np.asarray(processes, np.int64).reshape(self.devices.shape)

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def axis_names(self) -> tuple:
        return AXES

    @property
    def batch_devices(self) -> list:
        """The device of each batch position: a row's first device (the
        decoders do not use the stripe axis)."""
        return list(self.devices[:, 0])

    @property
    def first(self) -> torch.device:
        return self.devices[0, 0]

    def addressable(self, pos: tuple) -> bool:
        """Whether this process holds the device at mesh position ``pos``."""
        from .distributed import process_index

        return int(self.processes[pos]) == process_index()

    def _key(self):
        return (tuple(str(d) for d in self.devices.reshape(-1)), self.devices.shape,
                self.processes.tobytes())

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(devices=None, batch: int | None = None, stripe: int = 1) -> Mesh:
    """A ("batch", "stripe") mesh over ``devices`` (names or torch
    devices; one may repeat), or over every visible CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no card, and no CPU mesh by default
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if batch is None:
        batch = n // stripe
    if batch * stripe != n:
        raise ValueError(f"mesh {batch}x{stripe} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(batch, stripe))


class Sharding:
    """A placement on ``mesh``: ``spec[i]`` names the mesh axis that
    splits dimension i, or None (the dimension whole on every shard)."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def indices(self, shape) -> dict:
        """Mesh position (i, j) -> the index (a slice a dimension) of the
        part of an array of ``shape`` placed there, as
        ``NamedSharding.devices_indices_map`` gives it (a dimension no axis
        splits is slice(None)).  Raises ValueError where an axis does not
        divide its dimension, as ``jax.device_put`` does."""
        shape = tuple(shape)
        mshape = self.mesh.shape
        for dim, axis in enumerate(self.spec):
            if axis is not None and shape[dim] % mshape[axis]:
                raise ValueError(
                    f"the sharding {self.spec} over mesh {mshape} implies that the global "
                    f"size of dimension {dim} should be divisible by {mshape[axis]}, but it "
                    f"is equal to {shape[dim]} (full shape: {shape})")
        out = {}
        for pos in np.ndindex(*self.mesh.devices.shape):
            at = dict(zip(AXES, pos))
            idx = []
            for dim in range(len(shape)):
                axis = self.spec[dim] if dim < len(self.spec) else None
                if axis is None:
                    idx.append(slice(None))
                else:
                    part = shape[dim] // mshape[axis]
                    idx.append(slice(at[axis] * part, (at[axis] + 1) * part))
            out[pos] = tuple(idx)
        return out


def batch_sharding(mesh: Mesh, *, stripe_dim: int | None = None) -> Sharding:
    """Dimension 0 over "batch" (and dimension ``stripe_dim`` over
    "stripe")."""
    if stripe_dim is None:
        return Sharding(mesh, ("batch",))
    spec = [None] * (stripe_dim + 1)
    spec[0] = "batch"
    spec[stripe_dim] = "stripe"
    return Sharding(mesh, tuple(spec))


class Sharded:
    """An array held as shards on their devices: ``shards[k]`` is the part
    at ``indices[k]`` (a slice a dimension, in the global array of
    ``shape``).  ``complete`` is False where some shards live in other
    processes (``distributed.host_local_batch``); such an array cannot be
    gathered here."""

    def __init__(self, shards, indices, shape, complete: bool = True):
        self.shards = list(shards)
        self.indices = [tuple(i) for i in indices]
        self.shape = tuple(int(s) for s in shape)
        self.complete = complete
        if not self.shards:
            raise ValueError("Sharded: no shards")
        self.dtype = self.shards[0].dtype

    @classmethod
    def stack(cls, parts) -> "Sharded":
        """Tensors that hold consecutive rows of one batch (any number each,
        0 included) -> the batch, split on dimension 0 as they are."""
        parts = list(parts)
        rows, idx = 0, []
        for p in parts:
            idx.append((slice(rows, rows + p.shape[0]),) + (slice(None),) * (p.dim() - 1))
            rows += p.shape[0]
        return cls(parts, idx, (rows,) + tuple(parts[0].shape[1:]))

    @property
    def devices(self) -> list:
        return [t.device for t in self.shards]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def numpy(self) -> np.ndarray:
        """The whole array on the host (every shard copied once)."""
        if not self.complete:
            raise RuntimeError("Sharded: some shards are held by other processes")
        out = None
        for t, idx in zip(self.shards, self.indices):
            a = t.detach().cpu().numpy()
            if out is None:
                out = np.empty(self.shape, a.dtype)
            out[idx] = a
        return out

    def cpu(self) -> torch.Tensor:
        return torch.from_numpy(self.numpy())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return f"Sharded(shape={self.shape}, dtype={self.dtype}, devices={self.devices})"


def put(array, sharding: Sharding) -> Sharded:
    """``jax.device_put(array, sharding)``: each mesh position's part of
    ``array`` (numpy or a tensor) copied to that position's device."""
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(array))
    idx = sharding.indices(t.shape)
    devs = sharding.mesh.devices
    return Sharded([t[i].to(devs[pos]) for pos, i in idx.items()], list(idx.values()), t.shape)


# ------------------------------------------------------------ decoder helpers


def shard_bounds(mesh: Mesh, n: int, what: str) -> list:
    """[(device, lo, hi)] of each batch position: an equal run of the ``n``
    units (images or lanes) that ``what`` names.  Raises ValueError where
    the mesh's batch axis does not divide ``n``, as the JAX package does."""
    parts = mesh.shape["batch"]
    if n % parts:
        prefix, _, rest = what.partition(": ")
        raise ValueError(f"{prefix}: the mesh batch axis ({parts}) must divide {rest}; "
                         "pad the batch")
    per = n // parts
    return [(dev, k * per, (k + 1) * per) for k, dev in enumerate(mesh.batch_devices)]


def regroup(pieces, per_image: int):
    """Consecutive units of a batch split over devices -> whole images.

    ``pieces[k]``: a tensor whose dimension 0 holds the next units (lanes,
    rows) of the batch on position k's device; image b holds units
    [b * per_image, (b + 1) * per_image).  An image belongs to the position
    that holds its first unit; the units of its tail held elsewhere are
    copied to that position's device (a peer copy between cards, a copy on
    one).  -> per position, its images' units [n_k * per_image, ...] and
    n_k.  Where every position holds whole images nothing is copied."""
    bounds, lo = [], 0
    for p in pieces:
        bounds.append((lo, lo + p.shape[0]))
        lo += p.shape[0]
    out = []
    for k, (plo, phi) in enumerate(bounds):
        first = -(-plo // per_image)
        last = -(-phi // per_image)
        ulo, uhi = first * per_image, last * per_image
        dev = pieces[k].device
        got = []
        for j, (qlo, qhi) in enumerate(bounds):
            a, b = max(ulo, qlo), min(uhi, qhi)
            if a < b:
                got.append(pieces[j][a - qlo : b - qlo].to(dev))
        if not got:
            got = [pieces[k][:0]]
        out.append((got[0] if len(got) == 1 else torch.cat(got), last - first))
    return out


class DeviceUploads:
    """A ``PinnedUpload`` a shard device, made on first use (several mesh
    positions on one device share it); ``own``, the decoder's, serves its
    device, so a shard that is the whole plan goes up from the staging
    buffer its prep filled, with no packing copy."""

    def __init__(self, own: PinnedUpload):
        self._by_dev: dict = {own.device: own}
        self._lock = threading.Lock()

    def __call__(self, device) -> PinnedUpload:
        with self._lock:
            up = self._by_dev.get(device)
            if up is None:
                up = self._by_dev[device] = PinnedUpload(device)
            return up

    def runs(self, mesh: Mesh, arrays, what: str) -> list:
        """Each batch position's equal run of the arrays' rows (dimension
        0: images or lanes, as ``what`` names them), uploaded to its device
        in one copy -> a list of each run's device tensors."""
        return [self(dev)([a[lo:hi] for a in arrays])
                for dev, lo, hi in shard_bounds(mesh, len(arrays[0]), what)]


def mesh_device(mesh: Mesh | None, device):
    """A decoder's device: the mesh's first device with a mesh (then
    ``device`` must be None or that device), else ``resolve_device``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and _device(device) != mesh.first:
        raise ValueError("pass a mesh or a device, not both")
    return mesh.first


def all_ok(oks, device) -> torch.Tensor:
    """Per-shard 0-dim bool ``ok`` tensors -> their AND, a 0-dim bool on
    ``device``, with no host sync."""
    return torch.stack([o.to(device, non_blocking=True) for o in oks]).all()
