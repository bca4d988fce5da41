"""qwen2.5-14b [hf:Qwen/Qwen2.5-*]: 48L d=5120 40H (GQA kv=8) d_ff=13824,
vocab 152064, QKV bias. (``tp_size`` is the reference's tensor-parallel
plan: 40 heads do not divide its 16-way axis.)"""
from ..models.transformer import LMConfig
from .lm_common import LM_SHAPES, make_lm_cell

SHAPES = list(LM_SHAPES)


def get_config() -> LMConfig:
    return LMConfig(
        name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=13824, vocab=152064, d_head=128, qkv_bias=True,
        rope_theta=1e6, tp_size=16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen25-smoke", n_layers=2, d_model=60, n_heads=5, n_kv_heads=1,
        d_ff=128, vocab=128, d_head=12, qkv_bias=True, tp_size=2)


def make_cell(shape: str, multi_pod: bool = False):
    return make_lm_cell(get_config(), shape, multi_pod)
