"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L d=4096 32H (kv=32, MHA)
d_ff=13440, vocab 92416, QKV bias (qwen1.5 arch)."""
from ..models.transformer import LMConfig
from .lm_common import LM_SHAPES, make_lm_cell

SHAPES = list(LM_SHAPES)


def get_config() -> LMConfig:
    return LMConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, d_ff=13440, vocab=92416, d_head=128, qkv_bias=True,
        rope_theta=1e6, tp_size=16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="codeqwen-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, d_head=16, qkv_bias=True,
        tp_size=1)


def make_cell(shape: str, multi_pod: bool = False):
    return make_lm_cell(get_config(), shape, multi_pod)
