"""Optimizers of the port: AdamW and SGD with momentum, global-norm
clipping and the warmup-cosine schedule, the reference package's
`train/optim.py` in PyTorch.

States mirror the parameter tree (nested dicts of tensors, on the
parameters' device). The arithmetic is the reference's, in float32 and
in its order: the learning rate from a float32 step, the bias
corrections ``1 - b1 ** t`` from the float32 count, the gradient norm
summed over the leaves in tree order. Updates are functional: new
tensors come back and the inputs are left as they were.
`abstract_opt_state` and `opt_state_shardings` are the state's meta
tensors and `launch.mesh.Spec`s for the dry run, as the reference's.

Over parameters stored by their `Spec`s (`launch.mesh.Sharded`, the
reference's ZeRO-1 under FSDP specs), the moments are stored as the
parameters are: each shard's zeros on its device, each update computed
where its block lives. The global norm sums each distinct block once, a
partial sum a block on its device, added on the first leaf's device;
the step counter lives there, and the learning rate, the count and the
clip scale go to each device that needs them (one copy a device). A
tensor several shards of one device share is updated once and stays
shared.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..distributed.collectives import reduce_sum
from ..launch.mesh import Spec
from .tree import (distinct_leaves, flatten_with_paths, tree_leaves,
                   tree_map, unflatten_like)


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar: updates applied so far
    m: dict
    v: dict


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: dict


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def warmup_cosine(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor): linear warm-up,
    then a cosine down to ``min_lr_ratio * lr`` at ``total_steps``."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (each block of a
    `Sharded` leaf once, its partial sum on its device), summed in tree
    order on the first leaf's device."""
    leaves = distinct_leaves(grads)
    return torch.sqrt(reduce_sum([torch.sum(g.to(torch.float32) ** 2)
                                  for g in leaves], leaves[0].device))


class _OnDevices:
    """A tensor and its copies on the devices asked for (one each)."""

    def __init__(self, x: torch.Tensor):
        self.copies = {x.device: x}

    def on(self, device) -> torch.Tensor:
        if device not in self.copies:
            self.copies[device] = next(iter(self.copies.values())).to(device)
        return self.copies[device]


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling)."""
    gn = global_norm(grads)
    scale = _OnDevices(_clip_scale(gn, max_norm))
    return tree_map(lambda g: g * scale.on(g.device), grads), gn


def once_per_tensor(fn):
    """``fn`` over leaves, computed once a distinct first argument (the
    tensor several shards of one device share) and the result shared."""
    memo: dict = {}

    def call(x, *rest):
        if id(x) not in memo:
            memo[id(x)] = (x, fn(x, *rest))
        return memo[id(x)][1]

    return call


def init_opt_state(cfg: OptimizerConfig, params):
    def zeros():
        return tree_map(once_per_tensor(torch.zeros_like), params)
    device = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.name == "adamw":
        return AdamWState(step=step, m=zeros(), v=zeros())
    if cfg.name == "sgd":
        return SGDState(step=step, mom=zeros())
    raise ValueError(cfg.name)


def abstract_opt_state(cfg: OptimizerConfig, abstract_params):
    """`init_opt_state` over a tree of meta tensors, as meta tensors."""
    like = lambda: tree_map(  # noqa: E731
        lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"),
        abstract_params)
    step = torch.empty((), dtype=torch.int32, device="meta")
    if cfg.name == "adamw":
        return AdamWState(step=step, m=like(), v=like())
    if cfg.name == "sgd":
        return SGDState(step=step, mom=like())
    raise ValueError(cfg.name)


def opt_state_shardings(cfg: OptimizerConfig, param_specs):
    """The state's `Spec`s: the moments as the parameters, the step
    replicated."""
    if cfg.name == "adamw":
        return AdamWState(step=Spec(), m=param_specs, v=param_specs)
    if cfg.name == "sgd":
        return SGDState(step=Spec(), mom=param_specs)
    raise ValueError(cfg.name)


def apply_updates(cfg: OptimizerConfig, params, grads, state,
                  donate: bool = False):
    """One optimizer step. Returns (new_params, new_state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr`` (this step's).
    Each gradient leaf is clipped as its update reads it (no clipped
    copy of the whole tree). With ``donate`` the parameters and moments
    are updated in place (the same numbers; the reference's train cell
    donates them, `donate_argnums=(0, 1)`): the old values are gone, and
    no second copy of the state is held."""
    gnorm = global_norm(grads)
    scale = _OnDevices(_clip_scale(gnorm, cfg.clip_norm))
    lr = warmup_cosine(cfg, state.step)
    step = state.step + 1
    flat_p = flatten_with_paths(params)
    flat_g = flatten_with_paths(grads)
    lrs = _OnDevices(lr)
    if cfg.name == "adamw":
        b1, b2 = cfg.betas
        ts = _OnDevices(step.to(torch.float32))

        @once_per_tensor
        def upd(p, g, m, v):
            # the reference's expression, each product rounded where it
            # rounds, in place where a temporary allows: at most three
            # leaf-sized temporaries beside the new p, m, v
            g = (g * scale.on(g.device)).to(torch.float32)
            t = ts.on(p.device)
            m2 = (m.mul_(b1) if donate else m * b1).add_(g * (1 - b1))
            v2 = (v.mul_(b2) if donate else v * b2).add_(
                (g * (1 - b2)).mul_(g))
            del g
            step_p = m2 / (1 - b1 ** t)
            step_p.div_((v2 / (1 - b2 ** t)).sqrt_().add_(cfg.eps))
            step_p.add_(p * cfg.weight_decay)
            step_p.mul_(lrs.on(p.device))
            return (p.sub_(step_p) if donate else p - step_p), m2, v2

        flat_m = flatten_with_paths(state.m)
        flat_v = flatten_with_paths(state.v)
        out = {k: upd(p, flat_g[k], flat_m[k], flat_v[k])
               for k, p in flat_p.items()}
        new = [unflatten_like(params, {k: o[i] for k, o in out.items()})
               for i in range(3)]
        return new[0], AdamWState(step, new[1], new[2]), {
            "grad_norm": gnorm, "lr": lr}
    if cfg.name == "sgd":
        @once_per_tensor
        def upd(p, g, mom):
            mom2 = (mom.mul_(0.9) if donate else mom * 0.9).add_(
                (g * scale.on(g.device)).to(torch.float32))
            step_p = (p * cfg.weight_decay).add_(mom2).mul_(lrs.on(p.device))
            return (p.sub_(step_p) if donate else p - step_p), mom2

        flat_mom = flatten_with_paths(state.mom)
        out = {k: upd(p, flat_g[k], flat_mom[k]) for k, p in flat_p.items()}
        new = [unflatten_like(params, {k: o[i] for k, o in out.items()})
               for i in range(2)]
        return new[0], SGDState(step, new[1]), {"grad_norm": gnorm,
                                                "lr": lr}
    raise ValueError(cfg.name)
