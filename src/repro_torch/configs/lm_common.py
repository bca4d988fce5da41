"""Shapes and model-FLOP counts of the LM-family architectures, the
reference's `configs/lm_common.py`.

Shapes: train_4k (train), prefill_32k (inference prefill), decode_32k
(one token against a 32k KV cache), long_500k (one token against a 512k
cache, batch 1). The reference's `make_lm_cell` lowers JAX programs for
its dry run and has no counterpart here yet.
"""
from __future__ import annotations

from ..models.transformer import LMConfig

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


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
