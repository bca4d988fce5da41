"""dbrx-132b [hf:databricks/dbrx-base]: 40L d=6144 48H (GQA kv=8)
d_ff=10752, 16 experts top-4, vocab 100352. 131.6 B parameters (263 GB
in bfloat16): no single card holds it; the port runs it at
`smoke_config()` and counts its full-width cells in the dry run."""
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .lm_common import LM_SHAPES, make_lm_cell

SHAPES = list(LM_SHAPES)


def get_config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab=100352, d_head=128,
        rope_theta=5e5,
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752,
                      token_chunks=8, dispatch_shards=16),
        tp_size=16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128, d_head=16,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32), tp_size=1)


def make_cell(shape: str, multi_pod: bool = False):
    return make_lm_cell(get_config(), shape, multi_pod)
