"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim 10, CIN
200-200-200, MLP 400-400. Shapes: train_batch (65,536), serve_p99 (512),
serve_bulk (262,144), retrieval_cand (1 query x 1,000,000 candidates).
The port serves the last three and trains train_batch (`TRAIN_OPT`,
`make_train_step_for`, `train_flops`); `make_cell` is a shape's dry-run
`Cell`, the reference's."""
from __future__ import annotations

import torch

from ..launch.mesh import Spec as P
from ..models import xdeepfm as X
from ..models.xdeepfm import XDeepFMConfig
from ..train import optim as O
from ..train.loop import make_train_step
from ..train.optim import OptimizerConfig
from .cell import Cell, abstract, materialize, train_outs

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


def make_cell(shape: str, multi_pod: bool = False) -> Cell:
    """The dry-run cell of `get_config()` at ``shape``: the tables
    row-sharded over "model", the batch (and the candidates) over
    ("pod", "data")."""
    cfg = get_config()
    spec = _SHAPE_SPECS[shape]
    bd = ("pod", "data") if multi_pod else "data"
    ap = X.abstract_params(cfg)
    ps = X.param_shardings(cfg)
    meta = {"family": "recsys", "scan_trips": cfg.embed_dim,  # CIN d-scan
            "params": cfg.total_rows * (cfg.embed_dim + 1),
            "embed_rows": cfg.total_rows}
    B = spec["batch"]

    if spec["kind"] == "train":
        batch = {"ids": abstract((B, cfg.n_sparse), torch.int32),
                 "labels": abstract((B,), torch.int32)}
        bspec = {"ids": P(bd, None), "labels": P(bd)}
        ao = O.abstract_opt_state(TRAIN_OPT, ap)
        osd = O.opt_state_shardings(TRAIN_OPT, ps)
        meta["model_flops"] = train_flops(cfg, B)
        return Cell("xdeepfm", shape, "train", make_train_step_for(cfg),
                    (ap, ao, batch), (ps, osd, bspec), (ps, osd, None),
                    (0, 1), meta, outs=train_outs(ap, ao))

    if spec["kind"] == "serve":
        batch = {"ids": abstract((B, cfg.n_sparse), torch.int32)}

        def fn(params, batch):
            return X.forward(params, cfg, batch)

        meta["model_flops"] = flops_fwd(cfg, B)
        return Cell("xdeepfm", shape, "serve", fn, (ap, batch),
                    (ps, {"ids": P(bd, None)}), P(bd), (), meta,
                    outs=abstract((B,)))

    # retrieval: one query against 1M candidate embeddings
    C = spec["n_cand"]

    def fn(params, query_ids, cand_emb):
        _, (top_v, top_i) = X.retrieval_scores_of(params, cfg, query_ids,
                                                  cand_emb)
        return top_v, top_i.to(torch.int32)   # lax.top_k's int32 indices

    meta["model_flops"] = 2.0 * C * cfg.embed_dim
    return Cell("xdeepfm", shape, "retrieval", fn,
                (ap, abstract((1, cfg.n_sparse), torch.int32),
                 abstract((C, cfg.embed_dim))),
                (ps, P(None, None), P(bd, None)), None, (), meta,
                outs=(abstract((100,)), abstract((100,), torch.int32)))


def concrete_args(cell: Cell, generator: torch.Generator) -> tuple:
    """A cell's arguments drawn on the generator's device: each field's
    id inside its own vocabulary (global rows), labels 0 / 1."""
    cfg = get_config()
    args = materialize(cell.args, generator,
                       lambda path, t: (0, 2 if "labels" in path else 1))
    ids = (args[1] if cell.kind == "retrieval" else args[-1]["ids"])
    for f, (off, n) in enumerate(zip(cfg.field_offsets.tolist(),
                                     cfg.field_vocabs)):
        ids[:, f].random_(off, off + n, generator=generator)
    return args
