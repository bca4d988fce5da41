"""llama3-8b [arXiv:2407.21783]: 32L d=4096 32H (GQA kv=8) d_ff=14336,
vocab 128256."""
from ..models.transformer import LMConfig
from .lm_common import LM_SHAPES, make_lm_cell

SHAPES = list(LM_SHAPES)


def get_config() -> LMConfig:
    return LMConfig(
        name="llama3-8b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=128256, d_head=128,
        rope_theta=5e5, tp_size=16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, d_head=16, tp_size=1)


def make_cell(shape: str, multi_pod: bool = False):
    return make_lm_cell(get_config(), shape, multi_pod)
