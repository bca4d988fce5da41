"""The production mesh of the dry run and the serving mesh of the sharded
query engine, the reference package's `launch/mesh.py`.

The production mesh (`make_production_mesh`) is abstract: the
reference's axis names and shapes, ("data", "model") 16 x 16 and ("pod",
"data", "model") 2 x 16 x 16, read as 256 and 512 H100s, with no
devices behind them. A `Spec` is the reference's `PartitionSpec`, entry
for entry, and `shard_shape` gives the per-card shard of a global shape
under it by XLA's rule. The dry run (`launch.dryrun`) sums those shards;
nothing in the port is partitioned by them.

The serving mesh is the port of `make_serving_mesh` and `batch_axes`,
and the mesh of the model path's parallel code too (the sequence-sharded
decode, expert parallelism, the pipeline), with axes of its own.
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
