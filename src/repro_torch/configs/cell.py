"""A Cell = one (architecture x input-shape) point of the dry-run matrix,
the reference's `configs/cell.py`: everything needed to count the step
(`launch.op_analysis`) and size it on a production mesh
(`launch.mesh.make_production_mesh`) without allocating real data, and to
run it on the card where one holds it (`launch.dryrun`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..train.tree import flatten_with_paths, unflatten_like


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str            # train | prefill | decode | serve | retrieval
    fn: Callable                  # the port's step function
    args: tuple                   # abstract args (meta-tensor pytrees)
    in_shardings: tuple           # `launch.mesh.Spec` pytrees, as args
    out_shardings: Any = None
    donate_argnums: tuple = ()
    # meta for the roofline: analytic MODEL_FLOPS, the reference's scan
    # trip count, param counts, notes (equal to the reference's, key for key)
    meta: dict = dataclasses.field(default_factory=dict)
    # the step's result as a meta pytree: what `jax.eval_shape(fn, *args)`
    # gives the reference, which the port has no tracer for; a count of
    # the step (`launch.dryrun.count_cell`) checks its result against it
    outs: Any = None

    @property
    def name(self) -> str:
        return f"{self.arch}__{self.shape}"


def abstract(shape, dtype=torch.float32) -> torch.Tensor:
    """A meta tensor: the reference's `jax.ShapeDtypeStruct`."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_outs(params, opt_state) -> tuple:
    """A train step's result: the parameters and optimizer state as its
    arguments, and its float32 scalar metrics."""
    return params, opt_state, {k: abstract(()) for k in
                               ("grad_norm", "loss", "lr")}


def materialize(args, generator: torch.Generator, int_range,
                std: float = 0.02):
    """Concrete tensors for a tree of meta tensors, on the generator's
    device and drawn from it: floats normal(0, ``std``), integers uniform
    in ``int_range(path, leaf)`` = [lo, hi) (paths as
    `train.tree.flatten_with_paths` spells them)."""
    out = {}
    for path, t in flatten_with_paths(args).items():
        x = torch.empty(t.shape, dtype=t.dtype, device=generator.device)
        if t.dtype.is_floating_point:
            x.normal_(0.0, std, generator=generator)
        else:
            lo, hi = int_range(path, t)
            x.random_(lo, hi, generator=generator)
        out[path] = x
    return unflatten_like(args, out)
