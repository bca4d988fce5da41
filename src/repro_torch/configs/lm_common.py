"""Shared cell builders of the LM-family architectures, the reference's
`configs/lm_common.py`.

Shapes: train_4k (train), prefill_32k (inference prefill), decode_32k
(one token against a 32k KV cache), long_500k (one token against a 512k
cache, batch 1). decode and long_500k run `decode_step`, not the train
step. `make_lm_cell` builds a shape's dry-run `Cell`: the port's step
over meta-tensor arguments, with the reference's shardings, donation
and meta.
"""
from __future__ import annotations

import torch

from ..launch.mesh import Spec as P
from ..models import transformer as T
from ..models.transformer import LMConfig
from ..train import optim as O
from ..train.loop import make_train_step
from .cell import Cell, abstract, materialize, train_outs

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _bd(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def lm_flops_train(cfg: LMConfig, tokens: int) -> float:
    return 6.0 * cfg.active_param_count() * tokens


def lm_flops_prefill(cfg: LMConfig, batch: int, seq: int) -> float:
    """The dense 2ND term plus the full (unhalved) attention term."""
    dense = 2.0 * cfg.active_param_count() * batch * seq
    attn = 2.0 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.d_head
    return dense + attn


def lm_flops_decode(cfg: LMConfig, batch: int, kv_len: int) -> float:
    dense = 2.0 * cfg.active_param_count() * batch
    attn = 4.0 * cfg.n_layers * batch * kv_len * cfg.n_heads * cfg.d_head
    return dense + attn


def make_lm_cell(cfg: LMConfig, shape: str, multi_pod: bool = False) -> Cell:
    """The dry-run cell of ``cfg`` at ``shape``. The reference's residual
    and head sharding constraints (``act_spec``) have no counterpart: the
    port's step runs unpartitioned."""
    spec = LM_SHAPES[shape]
    bd = _bd(multi_pod)
    ps = T.param_shardings(cfg)
    ap = T.abstract_params(cfg)
    meta = {
        "family": "lm", "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "scan_trips": cfg.n_layers,
    }
    B, S = spec["batch"], spec["seq"]

    if spec["kind"] == "train":
        ocfg = O.OptimizerConfig()
        ao = O.abstract_opt_state(ocfg, ap)
        osd = O.opt_state_shardings(ocfg, ps)
        batch = {"tokens": abstract((B, S), torch.int32),
                 "labels": abstract((B, S), torch.int32)}
        bspec = {"tokens": P(bd, None), "labels": P(bd, None)}
        step = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), ocfg)
        meta["model_flops"] = lm_flops_train(cfg, B * S)
        meta["tokens"] = B * S
        return Cell(cfg.name, shape, "train", step, (ap, ao, batch),
                    (ps, osd, bspec), (ps, osd, None), (0, 1), meta,
                    outs=train_outs(ap, ao))

    if spec["kind"] == "prefill":
        toks = abstract((B, S), torch.int32)
        # KV cache: kv-heads over "model" where they divide it, else the
        # sequence over "model"
        if cfg.n_kv_heads % cfg.tp_size == 0:
            cspec_p = P(None, bd, None, "model", None)
        else:
            cspec_p = P(None, bd, "model", None, None)
        cache_spec = {"k": cspec_p, "v": cspec_p}
        meta["model_flops"] = lm_flops_prefill(cfg, B, S)
        meta["tokens"] = B * S
        return Cell(cfg.name, shape, "prefill",
                    lambda params, tokens: T.prefill_step(params, cfg,
                                                          tokens),
                    (ap, toks), (ps, P(bd, None)), (P(bd), cache_spec), (),
                    meta, outs=(abstract((B,), torch.int32),
                                T.init_cache_abstract(cfg, B, S)))

    # decode shapes
    cache = T.init_cache_abstract(cfg, B, S)
    if B == 1:
        # batch of one: shard the KV length over every mesh axis
        all_axes = (("pod", "data", "model") if multi_pod
                    else ("data", "model"))
        cspec = P(None, None, all_axes, None, None)
        tspec = P(None)
    elif cfg.n_kv_heads % cfg.tp_size == 0:
        # kv heads over "model": decode attention stays head-local
        cspec = P(None, bd, None, "model", None)
        tspec = P(bd)
    else:
        cspec = P(None, bd, "model", None, None)
        tspec = P(bd)
    cache_spec = {"k": cspec, "v": cspec}
    toks = abstract((B,), torch.int32)
    pos = abstract((), torch.int32)

    def fn(params, cache, tokens, pos):
        return T.decode_step(params, cfg, cache, tokens, pos)

    meta["model_flops"] = lm_flops_decode(cfg, B, S)
    meta["tokens"] = B
    meta["kv_bytes"] = (2 * cfg.n_layers * B * S * cfg.n_kv_heads
                        * cfg.d_head * 2)
    logits = abstract((B, cfg.vocab), T.DTYPES[cfg.compute_dtype])
    return Cell(cfg.name, shape, "decode", fn, (ap, cache, toks, pos),
                (ps, cache_spec, tspec, P()),
                (tspec, P(bd if B > 1 else None, "model"), cache_spec),
                (1,), meta, outs=(toks, logits, cache))


def concrete_args(cell: Cell, generator: torch.Generator) -> tuple:
    """A cell's arguments drawn on the generator's device: tokens and
    labels in the vocabulary, a decode position inside the cache."""
    vocab = cell.args[0]["embed"].shape[0]

    def int_range(path, t):
        if cell.kind == "decode" and path == "3":
            return 0, cell.args[1]["k"].shape[2]
        if path.endswith(".step"):
            return 0, 1
        return 0, vocab

    return materialize(cell.args, generator, int_range)
