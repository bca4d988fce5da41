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
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..launch.mesh import Spec
from .tree import flatten_with_paths, tree_leaves, tree_map, unflatten_like


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
    """sqrt of the sum of squares of every leaf, summed in tree order."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(g.to(torch.float32) ** 2)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


def init_opt_state(cfg: OptimizerConfig, params):
    zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
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


def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One optimizer step. Returns (new_params, new_state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr`` (this step's)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    lr = warmup_cosine(cfg, state.step)
    step = state.step + 1
    flat_p = flatten_with_paths(params)
    flat_g = flatten_with_paths(grads)
    if cfg.name == "adamw":
        b1, b2 = cfg.betas
        t = step.to(torch.float32)

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mhat = m2 / (1 - b1 ** t)
            vhat = v2 / (1 - b2 ** t)
            step_p = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * p
            return p - lr * step_p, m2, v2

        flat_m = flatten_with_paths(state.m)
        flat_v = flatten_with_paths(state.v)
        out = {k: upd(p, flat_g[k], flat_m[k], flat_v[k])
               for k, p in flat_p.items()}
        new = [unflatten_like(params, {k: o[i] for k, o in out.items()})
               for i in range(3)]
        return new[0], AdamWState(step, new[1], new[2]), {
            "grad_norm": gnorm, "lr": lr}
    if cfg.name == "sgd":
        def upd(p, g, mom):
            mom2 = 0.9 * mom + g.to(torch.float32)
            return p - lr * (mom2 + cfg.weight_decay * p), mom2

        flat_mom = flatten_with_paths(state.mom)
        out = {k: upd(p, flat_g[k], flat_mom[k]) for k, p in flat_p.items()}
        new = [unflatten_like(params, {k: o[i] for k, o in out.items()})
               for i in range(2)]
        return new[0], SGDState(step, new[1]), {"grad_norm": gnorm,
                                                "lr": lr}
    raise ValueError(cfg.name)
