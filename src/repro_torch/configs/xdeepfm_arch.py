"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim 10, CIN
200-200-200, MLP 400-400. Shapes: train_batch (65,536), serve_p99 (512),
serve_bulk (262,144), retrieval_cand (1 query x 1,000,000 candidates).
The port serves the last three and trains train_batch (`TRAIN_OPT`,
`make_train_step_for`, `train_flops`: the reference's `make_cell`
"train" shape without its dry-run shardings)."""
from __future__ import annotations

from ..models import xdeepfm as X
from ..models.xdeepfm import XDeepFMConfig
from ..train.loop import make_train_step
from ..train.optim import OptimizerConfig

SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

_SHAPE_SPECS = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}


def get_config() -> XDeepFMConfig:
    return XDeepFMConfig("xdeepfm")


def smoke_config() -> XDeepFMConfig:
    return XDeepFMConfig("xdeepfm-smoke", n_sparse=6, embed_dim=4,
                         cin_layers=(8, 8), mlp_layers=(16,),
                         big_fields=2, big_vocab=64, small_vocab=16)


def cin_flops(cfg: XDeepFMConfig, B: int) -> list:
    """FLOP of each CIN layer's forward at batch B: 2*B*K*H*M*D."""
    out, h_prev = [], cfg.n_sparse
    for k in cfg.cin_layers:
        out.append(2.0 * B * k * h_prev * cfg.n_sparse * cfg.embed_dim)
        h_prev = k
    return out


def flops_fwd(cfg: XDeepFMConfig, B: int) -> float:
    """Forward FLOP at batch B: the CIN layers and the MLP (the
    reference's `_flops_fwd`)."""
    f = sum(cin_flops(cfg, B))
    d_in = cfg.n_sparse * cfg.embed_dim
    for w in cfg.mlp_layers:
        f += 2.0 * B * d_in * w
        d_in = w
    f += 2.0 * B * d_in
    return f


# the train_batch shape's optimizer (the reference's `make_cell`)
TRAIN_OPT = OptimizerConfig(lr=1e-3, weight_decay=0.0)


def train_flops(cfg: XDeepFMConfig, B: int) -> float:
    """A train step's model FLOP at batch B: three forwards' worth (the
    reference's ``meta["model_flops"]``)."""
    return 3.0 * flops_fwd(cfg, B)


def make_train_step_for(cfg: XDeepFMConfig,
                        opt_cfg: OptimizerConfig = TRAIN_OPT, **kw):
    """`make_train_step` over the functional xDeepFM loss at ``cfg``
    (``kw``: ``accum_steps``, ``compress_grads``)."""
    return make_train_step(lambda p, b: X.loss_fn(p, cfg, b), opt_cfg, **kw)
