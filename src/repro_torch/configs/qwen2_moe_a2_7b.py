"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16)
d_ff_expert=1408 vocab=151936, 60 routed experts top-4 + 4 shared.
60 experts pad to 64 (the reference's expert-parallel divisibility)."""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .lm_common import LM_SHAPES, make_lm_cell

SHAPES = list(LM_SHAPES)


def get_config() -> LMConfig:
    return LMConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=151936, d_head=128, qkv_bias=True,
        rope_theta=1e6,
        moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                      num_shared=4, shared_gate=True, pad_experts_to=64,
                      token_chunks=8, dispatch_shards=16),
        tp_size=16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab=128, d_head=16, qkv_bias=True,
        moe=MoEConfig(num_experts=6, top_k=4, d_ff_expert=32, num_shared=2,
                      shared_gate=True, pad_experts_to=8),
        tp_size=1)


def make_cell(shape: str, multi_pod: bool = False):
    return make_lm_cell(get_config(), shape, multi_pod)
