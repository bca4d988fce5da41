"""The serving mesh of the sharded query engine.

Port of `make_serving_mesh` and `batch_axes` from the reference
package's `launch/mesh.py`. The reference drives every device from one
Python process through `shard_map` over a `jax.sharding.Mesh`; the port
keeps that single controller. A mesh here is an ordered tuple of
`torch.device`s with axis names and a shape: the engine issues each
shard's work itself, and the collectives (`distributed.collectives`) take
one tensor per shard. A device may appear more than once: eight logical
shards on ``cuda:0`` run every shard's own plan and launch on one card,
as the reference's dry run runs eight virtual devices on one host.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """Shards in row-major order over ``axis_names`` / ``shape``:
    ``("data",)`` with shape ``(n,)``, or ``("pod", "data")`` with shape
    ``(2, n // 2)``. ``devices[k]`` holds shard k (its linear index)."""

    devices: tuple
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def physical_devices(self) -> tuple:
        """The distinct devices of the mesh, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_axes(multi_pod: bool):
    """Mesh axes that shard the query batch."""
    return ("pod", "data") if multi_pod else ("data",)


def make_serving_mesh(devices=None, *, multi_pod: bool = False
                      ) -> ServingMesh:
    """The mesh of the sharded serving path. ``devices=None`` means every
    visible CUDA device, and raises where there is none (there is no CPU
    fallback: pass the devices, e.g. ``[torch.device("cpu")] * 8``).
    Repeats are allowed: ``[torch.device("cuda:0")] * 8`` is an 8-shard
    mesh on one card. ``multi_pod=True`` splits off a leading "pod" axis
    of 2 and needs an even count."""
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
    if multi_pod:
        if n % 2:
            raise ValueError(f"multi_pod mesh needs an even device count, "
                             f"got {n}")
        return ServingMesh(devices, ("pod", "data"), (2, n // 2))
    return ServingMesh(devices, ("data",), (n,))
