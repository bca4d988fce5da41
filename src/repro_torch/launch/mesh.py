"""The production mesh of the dry run and the serving mesh of the sharded
query engine, the reference package's `launch/mesh.py`.

The production mesh (`make_production_mesh`) is abstract: the
reference's axis names and shapes, ("data", "model") 16 x 16 and ("pod",
"data", "model") 2 x 16 x 16, read as 256 and 512 H100s, with no
devices behind them. A `Spec` is the reference's `PartitionSpec`, entry
for entry, and `shard_shape` gives the per-card shard of a global shape
under it by XLA's rule. The dry run (`launch.dryrun`) sums those
shards.

The serving mesh is the port of `make_serving_mesh` and `batch_axes`,
and the mesh of the model path's parallel code too (the sequence-sharded
decode, expert parallelism, the pipeline, training), with axes of its
own. On it a leaf is stored by its `Spec` as the reference's
`jax.device_put(leaf, NamedSharding(mesh, spec))` stores it: a `Sharded`
list holds each shard's block (`block_region`, XLA's rule, the same
block as the reference's addressable shard), `join_leaf` joins them
back, and `split_rows` splits a batch's rows over the data axes
(`place_batch` stores a batch by a cell's batch specs instead).
The reference drives every device from one Python process through
`shard_map` over a `jax.sharding.Mesh`; the port keeps that single
controller. A mesh here is an ordered tuple of
`torch.device`s with axis names and a shape: the engine issues each
shard's work itself, and the collectives (`distributed.collectives`) take
one tensor per shard. A device may appear more than once: eight logical
shards on ``cuda:0`` run every shard's own plan and launch on one card,
as the reference's dry run runs eight virtual devices on one host.
"""
from __future__ import annotations

import dataclasses
import math

import torch


# ------------------------------------------------------- the production mesh
@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """An abstract device mesh: named axes and their sizes, no devices."""

    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh: ("data", "model") 16 x 16, or with
    ``multi_pod`` ("pod", "data", "model") 2 x 16 x 16."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


class Spec:
    """The reference's `PartitionSpec`: one entry per leading dimension,
    each None (replicated), an axis name, or a tuple of axis names (the
    dimension split over their product, major to minor); dimensions past
    the last entry are replicated. A one-name tuple is that name, as in
    JAX. A leaf of the port's trees (not a tuple)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"Spec{self.entries!r}"


def shard_shape(shape, spec, mesh: ProductionMesh) -> tuple:
    """The per-card shard of a global ``shape`` under ``spec`` (None: fully
    replicated): each dimension divided by the product of its entry's axis
    sizes, rounded up (XLA's rule: the last shard is padded)."""
    entries = tuple(spec or ())
    if len(entries) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, n in enumerate(shape):
        e = entries[i] if i < len(entries) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        out.append(-(-n // math.prod(mesh.axis_size(a) for a in names)))
    return tuple(out)


# ---------------------------------------------------------- the serving mesh


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """Shards in row-major order over ``axis_names`` / ``shape``:
    ``("data",)`` with shape ``(n,)``, ``("pod", "data")`` with shape
    ``(2, n // 2)``, or any named axes the caller gives (the model
    path's ``("data", "model")``). ``devices[k]`` holds shard k (its
    linear index)."""

    devices: tuple
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def physical_devices(self) -> tuple:
        """The distinct devices of the mesh, in first-use order."""
        return tuple(dict.fromkeys(self.devices))

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self, k: int) -> dict:
        """Shard k's coordinate on each axis, by name (row-major)."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            k, out[name] = divmod(k, n)
        return out


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_axes(multi_pod: bool):
    """Mesh axes that shard the query batch."""
    return ("pod", "data") if multi_pod else ("data",)


# ------------------------------------------ a leaf stored by its Spec
def _axis(mesh, name: str, coords: dict) -> tuple:
    """(size, coordinate) of axis ``name``; an axis the mesh lacks is
    one shard."""
    if name not in mesh.axis_names:
        return 1, 0
    return mesh.axis_size(name), coords[name]


def block_region(shape, spec, mesh: ServingMesh, k: int) -> tuple:
    """Shard k's block of a global ``shape`` under ``spec``: per
    dimension its ``(start, stop)``. A dimension split over axes (major
    to minor) takes blocks of ``ceil(n / p)`` (XLA's rule: the last block
    is short, or empty, where p does not divide n); an axis the mesh
    lacks counts as size 1."""
    coords = mesh.coords(k)
    entries = tuple(spec or ())
    if len(entries) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, n in enumerate(shape):
        e = entries[i] if i < len(entries) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        p, idx = 1, 0
        for a in names:
            size, c = _axis(mesh, a, coords)
            p, idx = p * size, idx * size + c
        b = -(-n // p)
        lo = min(idx * b, n)
        out.append((lo, min(lo + b, n)))
    return tuple(out)


def region_slices(region, origin=None) -> tuple:
    """``region`` as slices, relative to ``origin`` (a start a
    dimension) if given."""
    origin = origin or (0,) * len(region)
    return tuple(slice(a - o, b - o) for (a, b), o in zip(region, origin))


class Sharded(list):
    """A leaf stored by its `Spec` over a `ServingMesh`: entry k is shard
    k's block (`block_region`) on ``mesh.devices[k]``. Shards that differ
    only on axes the spec does not name hold the same block; those on
    one device share one tensor. ``shape`` is the global leaf's. A list,
    so the port's trees (`train.tree`) walk its blocks as structure."""

    def __init__(self, blocks, spec, mesh: ServingMesh, shape):
        super().__init__(blocks)
        self.spec, self.mesh, self.shape = spec, mesh, tuple(shape)
        if len(self) != mesh.size:
            raise ValueError(f"{len(self)} blocks for {mesh.size} shards")

    def like(self, blocks) -> "Sharded":
        """The same storage plan over other ``blocks``."""
        return Sharded(blocks, self.spec, self.mesh, self.shape)

    def region(self, k: int) -> tuple:
        return block_region(self.shape, self.spec, self.mesh, k)

    def groups(self) -> dict:
        """{region: the shards holding it, in linear order}."""
        out: dict = {}
        for k in range(self.mesh.size):
            out.setdefault(self.region(k), []).append(k)
        return out

    def owners(self) -> list:
        """The first shard of each distinct block, in linear order."""
        return [ks[0] for ks in self.groups().values()]

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    def unbind(self) -> list:
        """The leaf's slices along dimension 0 (a stacked layer axis the
        spec leaves whole), each `Sharded` over views of the blocks:
        `torch.unbind` of each distinct tensor once, so the gradient of
        all slices comes back as one stack."""
        if self.spec and len(self.spec) and tuple(self.spec)[0] is not None:
            raise ValueError(f"dimension 0 of {self.spec} is split")
        views: dict = {}
        for b in self:
            if id(b) not in views:
                views[id(b)] = b.unbind(0)
        spec = Spec(*tuple(self.spec or ())[1:])
        return [Sharded([views[id(b)][i] for b in self], spec, self.mesh,
                        self.shape[1:]) for i in range(self.shape[0])]


def shard_leaf(x: torch.Tensor, spec, mesh: ServingMesh) -> Sharded:
    """``x`` stored by ``spec`` over ``mesh``: each shard's block on its
    device, one tensor a (block, device). A block on the device ``x`` is
    already on is a view of it (no copy)."""
    copies: dict = {}
    out = []
    for k, dev in enumerate(mesh.devices):
        region = block_region(x.shape, spec, mesh, k)
        key = (region, dev)
        if key not in copies:
            copies[key] = x[region_slices(region)].to(dev)
        out.append(copies[key])
    return Sharded(out, spec, mesh, x.shape)


def join_leaf(leaf: Sharded, device=None) -> torch.Tensor:
    """The whole leaf from its blocks, on ``device`` (shard 0's by
    default): the inverse of `shard_leaf`."""
    device = device or leaf[0].device
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    for region, ks in leaf.groups().items():
        out[region_slices(region)] = leaf[ks[0]]
    return out


def leaf_bytes(leaf: Sharded, device) -> int:
    """Bytes of the distinct tensors ``leaf`` keeps on ``device``."""
    seen = {id(b): b for b in leaf if b.device == torch.device(device)}
    return sum(b.numel() * b.element_size() for b in seen.values())


def data_shards(mesh: ServingMesh) -> list:
    """For each data shard, in row-major order over the axes that split
    a batch's rows (those of `batch_axes(True)` the mesh has), the first
    shard (linear index) that holds it: the one that computes its
    rows."""
    axes = tuple(a for a in batch_axes(True) if a in mesh.axis_names)
    first: dict = {}
    for k in range(mesh.size):
        c = mesh.coords(k)
        d = 0
        for a in axes:
            d = d * mesh.axis_size(a) + c[a]
        first.setdefault(d, k)
    return [first[d] for d in sorted(first)]


def split_rows(x, mesh: ServingMesh) -> list:
    """A batch array's rows split over the data shards: block d (rows
    ``d * B / D`` on) on the device of data shard d. An array already
    split (a list) is returned as it is."""
    if isinstance(x, (list, tuple)):
        return list(x)
    ks = data_shards(mesh)
    x = torch.as_tensor(x)
    if x.shape[0] % len(ks):
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{len(ks)} data shards")
    n = x.shape[0] // len(ks)
    return [x[d * n:(d + 1) * n].to(mesh.devices[k])
            for d, k in enumerate(ks)]


def _splits_rows(spec, mesh: ServingMesh) -> bool:
    """Whether ``spec``'s first entry names the axes of the mesh that
    split a batch's rows; naming only some of them raises (a data shard
    would hold another's rows too)."""
    entries = tuple(spec or ())
    if not entries or entries[0] is None:
        return False
    names = (entries[0],) if isinstance(entries[0], str) else entries[0]
    data = [a for a in batch_axes(True) if a in mesh.axis_names]
    named = [a for a in names if a in mesh.axis_names]
    if named and named != data:
        raise ValueError(f"{spec} splits rows over {named}, the mesh's data "
                         f"axes are {data}")
    return bool(named)


def place_batch(batch: dict, mesh: ServingMesh, specs: dict) -> dict:
    """A batch stored by the cell's batch specs: each key a `Sharded`
    leaf (`shard_leaf`). A key whose spec names the data axes becomes
    row blocks on the data shards; every other key is replicated, one
    copy a device. A key already `Sharded` is kept; a key without a spec
    is replicated. Rows that do not split evenly over the data shards
    raise (XLA would pad the last block)."""
    n = len(data_shards(mesh))
    out = {}
    for key, x in batch.items():
        if isinstance(x, Sharded):
            out[key] = x
            continue
        spec = specs.get(key)
        x = torch.as_tensor(x)
        if _splits_rows(spec, mesh):
            if x.shape[0] % n:
                raise ValueError(f"{key}: {x.shape[0]} rows do not split "
                                 f"over {n} data shards")
        else:
            spec = Spec()
        out[key] = shard_leaf(x, spec, mesh)
    return out


def make_serving_mesh(devices=None, *, multi_pod: bool = False,
                      axes: dict | None = None) -> ServingMesh:
    """The mesh of the sharded paths. ``devices=None`` means every
    visible CUDA device, and raises where there is none (there is no CPU
    fallback: pass the devices, e.g. ``[torch.device("cpu")] * 8``).
    Repeats are allowed: ``[torch.device("cuda:0")] * 8`` is an 8-shard
    mesh on one card. ``multi_pod=True`` splits off a leading "pod" axis
    of 2 and needs an even count. ``axes`` names the axes and their
    sizes in row-major order instead (``{"data": 2, "model": 4}``); their
    product must be the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the serving "
                               "mesh; pass devices= (e.g. "
                               "[torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    n = len(devices)
    if n == 0:
        raise ValueError("a serving mesh needs at least one device")
    if axes is not None:
        if multi_pod:
            raise ValueError("pass either multi_pod or axes")
        if math.prod(axes.values()) != n:
            raise ValueError(f"mesh axes {axes} do not hold {n} devices")
        return ServingMesh(devices, tuple(axes), tuple(axes.values()))
    if multi_pod:
        if n % 2:
            raise ValueError(f"multi_pod mesh needs an even device count, "
                             f"got {n}")
        return ServingMesh(devices, ("pod", "data"), (2, n // 2))
    return ServingMesh(devices, ("data",), (n,))
