"""The train step and the host loop that runs it, the reference package's
`train/loop.py` in PyTorch.

`make_train_step` keeps the reference's functional contract,
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``,
over a nested dict of tensors: the gradient comes from
`torch.autograd.grad` on leaves made from the parameters (no copy), and
the update returns new tensors. `Trainer` drives steps, waits for each
loss on the host, watches the step time (`StepTimeMonitor`) and saves
checkpoints.

Over a mesh (``make_train_step(..., mesh=m)``), the parameters and the
optimizer state are stored by their `Spec`s (`launch.mesh.Sharded`
leaves: `models.transformer.shard_params`, or `init_params(...,
mesh=m)`), and the batch's rows split over the mesh's data axes, each
data shard's block on the device that computes it (or each key stored
by the cell's batch spec, ``batch_specs=``: the graph family's), the
reference's train step under its cell's ``(param, opt_state, batch)``
shardings. The loss function reads the split batch (a list of row
blocks a leaf) and returns the global loss; every block's gradient is
summed on its own device by the gathers' backward, and a replicated
block's replicas' parts in linear shard order (`sum_replicas`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..distributed.collectives import sum_replicas
from ..launch.mesh import Sharded, place_batch, split_rows
from . import optim as O
from .optim import once_per_tensor
from .grad_compress import compress_decompress, compress_decompress_sharded
from .tree import flatten_with_paths, map_sharded, tree_map, unflatten_like


def value_and_grad(loss_fn: Callable, one_thread: bool = False):
    """``(params, batch) -> (loss, grads)``: the loss (detached) and its
    gradient with respect to every leaf of ``params``, in its structure
    (zeros where the loss does not reach a leaf, as in JAX). The blocks
    of a `Sharded` leaf that several shards hold get the sum of their
    parts, on each of them (`sum_replicas`).

    one_thread: every backward, the loss's own ones too (NequIP's
    forces), runs on the calling thread. The autograd engine otherwise
    runs a thread a card, adds a tensor's gradients in the order they
    arrive and sends a node whose gradients are all absent to the CPU's
    thread, so a double backward across cards could add in another order
    on other cards, or again (the graph family's mesh steps take it)."""

    def fn(params, batch):
        flat = {k: v.detach().requires_grad_(True)
                for k, v in flatten_with_paths(params).items()}
        with torch.enable_grad(), \
                torch.autograd.set_multithreading_enabled(not one_thread):
            loss = loss_fn(unflatten_like(params, flat), batch)
            grads = torch.autograd.grad(loss, list(flat.values()),
                                        allow_unused=True)
        tree = map_sharded(
            lambda g: sum_replicas(g) if isinstance(g, Sharded) else g,
            unflatten_like(params, dict(zip(flat, grads))))
        return loss.detach(), tree_map(
            lambda g, p: torch.zeros_like(p) if g is None else g, tree,
            params)

    return fn


def _compress(g):
    if isinstance(g, Sharded):
        return compress_decompress_sharded(g)
    return compress_decompress(g)[0]


def _microbatches(batch: dict, accum_steps: int) -> list:
    """The batch's leading axis split into ``accum_steps`` equal parts, in
    order (numpy arrays or tensors)."""
    split = {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum_steps)]


def make_train_step(loss_fn: Callable, opt_cfg: O.OptimizerConfig,
                    accum_steps: int = 1, compress_grads: bool = False,
                    mesh=None, donate: bool = False,
                    batch_specs: dict | None = None,
                    one_thread: bool = False):
    """loss_fn(params, batch) -> scalar. Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    accum_steps > 1: the batch's leading axis is split into microbatches;
    their losses and gradients are summed in order from zero, then
    divided by ``accum_steps``. compress_grads: each gradient leaf is
    int8-quantized and dequantized before the optimizer (no residual is
    carried, as in the reference's step). mesh: a
    `launch.mesh.ServingMesh` over which the parameters and the state
    are stored (see the module's note); each microbatch's rows are split
    over its data axes (`launch.mesh.split_rows`) before ``loss_fn``,
    or, given ``batch_specs`` ({key: Spec}, a cell's batch specs), each
    key stored by its spec (`launch.mesh.place_batch`: rows over the data
    shards where the spec names the data axes, else replicated).
    donate: the step updates ``params`` and ``opt_state`` in place and
    returns them (`optim.apply_updates`): the reference's train cell
    donates both; the caller must not read the old values. one_thread:
    see `value_and_grad`."""
    grad_fn = value_and_grad(loss_fn, one_thread)

    def place(b):
        if mesh is None:
            return b
        if batch_specs is not None:
            return place_batch(b, mesh, batch_specs)
        return {k: split_rows(v, mesh) for k, v in b.items()}

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = grad_fn(params, place(batch))
        else:
            loss = 0.0
            grads = tree_map(once_per_tensor(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)), params)
            for mb in _microbatches(batch, accum_steps):
                l, g = grad_fn(params, place(mb))
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        if compress_grads:
            grads = map_sharded(_compress, grads)
        params, opt_state, m = O.apply_updates(opt_cfg, params, grads,
                                               opt_state, donate=donate)
        m["loss"] = loss
        return params, opt_state, m

    return train_step


@dataclasses.dataclass
class StepTimeMonitor:
    """EMA-based straggler detector: flags steps whose duration exceeds
    mean + z * std of the running estimate."""
    alpha: float = 0.1
    z: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            self.mean = dt
            return False
        is_straggler = dt > self.mean + self.z * (self.var ** 0.5 + 1e-9) \
            and self.n > 5
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if is_straggler:
            self.stragglers += 1
        return is_straggler


def _scalar(v) -> float:
    """A metric as a host float (waits for the device where it is a
    tensor there)."""
    return v.item() if torch.is_tensor(v) else float(np.asarray(v))


class Trainer:
    """Host loop: runs steps, records metrics, periodic checkpoints.
    Each step's time runs until its loss is on the host (`.item()`)."""

    def __init__(self, train_step, params, opt_state, *,
                 checkpoint_manager=None, ckpt_every: int = 0):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.ckpt = checkpoint_manager
        self.ckpt_every = ckpt_every
        self.monitor = StepTimeMonitor()
        self.history: list[dict] = []
        self.step = 0

    def run(self, batches, max_steps: Optional[int] = None):
        for batch in batches:
            t0 = time.perf_counter()
            self.params, self.opt_state, m = self.train_step(
                self.params, self.opt_state, batch)
            rec = {k: _scalar(v) for k, v in m.items()}
            dt = time.perf_counter() - t0
            straggler = self.monitor.observe(dt)
            rec.update(step=self.step, time_s=dt, straggler=straggler)
            self.history.append(rec)
            self.step += 1
            if self.ckpt and self.ckpt_every and \
                    self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, {"params": self.params,
                                           "opt_state": self.opt_state})
            if max_steps and self.step >= max_steps:
                break
        return self.history
