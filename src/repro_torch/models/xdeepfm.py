"""xDeepFM (arXiv:1803.05170): sparse embeddings + CIN + DNN + linear,
the port of the reference's `models/xdeepfm.py`, serving and training.

Parameters keep the reference's names and layouts (``embed [R, D]``,
``linear [R, 1]``, ``bias [1]``, ``cin.w{i} [K, H, M]``, ``cin.out_w``,
``mlp.w{i} [in, out]``, ``mlp.b{i}``, ``mlp.out_w``; products are
``h @ w``), so `params_from_numpy` carries the reference's
`init_params` across as it is. Each CIN layer is one `ops.cin_layer`
call: kernel K11 on the card, its plain version on the CPU (the
reference's model path computes the same contraction as a `lax.scan`
over D slices; its Pallas kernel is the fused form). The MLP is a plain
`torch.matmul`, as the reference leaves it to XLA.

The model is one functional path, `forward` / `loss_fn(params, cfg,
batch)` over a nested dict of tensors, the reference's signature
(`param_tree` gives a module's, `params_to_numpy` their numpy copy).
Serving calls the `XDeepFM` module, which runs that path over its own
weights; they do not require gradients. Training's gradients come from
autograd, through `ops.CinLayer` (K11 and K12 on the card) and
`common.gather_rows` (a deterministic embedding gradient).
`param_specs` holds the reference's `PartitionSpec`s (the tables
row-sharded over "model"), for the dry run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..kernels import ops
from ..kernels._cuda import resolve_device
from ..launch.mesh import Spec as P
from .common import (abstract_tree, gather_rows, load_numpy_tree,
                     nest_params, param_tree, register_params,
                     tree_to_numpy, trunc_normal)


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_layers: tuple = (400, 400)
    # criteo-like skewed vocabulary: a few huge fields + many small ones
    big_fields: int = 8
    big_vocab: int = 1_000_000
    small_vocab: int = 1_000
    compute_dtype: str = "float32"

    @property
    def field_vocabs(self) -> tuple:
        return tuple([self.big_vocab] * self.big_fields +
                     [self.small_vocab] * (self.n_sparse - self.big_fields))

    @property
    def total_rows(self) -> int:
        # padded to 512 as in the reference (there, so row-sharding
        # divides any mesh axis); pad rows are never indexed
        raw = sum(self.field_vocabs)
        return -(-raw // 512) * 512

    @property
    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.field_vocabs)[:-1]])


# ------------------------------------------------------------ embedding bag
def embedding_bag(table, ids, bag_ids, num_bags: int, mode: str = "sum",
                  weights=None):
    """EmbeddingBag from a gather and an index add. table [R, D]; ids [K]
    row indices; bag_ids [K] the bag of each id; mode sum | mean (a bag
    with no ids gives zeros in both)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be sum or mean, got "
                         f"{mode!r}")
    bag_ids = bag_ids.long()
    rows = table.index_select(0, ids.long())
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros((num_bags, table.shape[1]), dtype=rows.dtype,
                      device=table.device)
    out.index_add_(0, bag_ids, rows)
    if mode == "mean":
        cnt = torch.zeros(num_bags, dtype=torch.float32, device=table.device)
        cnt.index_add_(0, bag_ids, torch.ones(bag_ids.shape[0],
                                              device=table.device))
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


# --------------------------------------------------------------- param defs
def param_defs(cfg: XDeepFMConfig) -> dict:
    """Parameter path -> shape, in the reference's order."""
    D = cfg.embed_dim
    defs = {"embed": (cfg.total_rows, D), "linear": (cfg.total_rows, 1),
            "bias": (1,)}
    h_prev = cfg.n_sparse
    for i, k in enumerate(cfg.cin_layers):
        defs[f"cin.w{i}"] = (k, h_prev, cfg.n_sparse)
        h_prev = k
    defs["cin.out_w"] = (sum(cfg.cin_layers), 1)
    d_in = cfg.n_sparse * D
    for i, width in enumerate(cfg.mlp_layers):
        defs[f"mlp.w{i}"] = (d_in, width)
        defs[f"mlp.b{i}"] = (width,)
        d_in = width
    defs["mlp.out_w"] = (d_in, 1)
    return defs


def param_specs(cfg: XDeepFMConfig) -> dict:
    """{path: Spec}, the reference's: the embedding and linear tables
    row-sharded over "model", the MLP's hidden widths over "model", the
    rest replicated."""
    specs = {}
    for path, shape in param_defs(cfg).items():
        if path in ("embed", "linear"):
            specs[path] = P("model", None)
        elif path.startswith("mlp.w"):
            specs[path] = P(None, "model")
        elif path.startswith("mlp.b"):
            specs[path] = P("model")
        else:
            specs[path] = P(*([None] * len(shape)))
    return specs


def abstract_params(cfg: XDeepFMConfig) -> dict:
    return abstract_tree(param_defs(cfg))


def param_shardings(cfg: XDeepFMConfig) -> dict:
    return nest_params(param_specs(cfg))


def _is_bias(path: str) -> bool:
    return path.endswith("bias") or ".b" in path


# ------------------------------------------------------------------ forward
def cin_features(cin: dict, x0: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network: one `ops.cin_layer` per layer
    (K11 on the card). ``cin`` is the dict of its weights; x0 [B, M, D];
    returns [B, sum(cin_layers)], each layer's output summed over D."""
    xk, pooled, i = x0, [], 0
    while f"w{i}" in cin:
        out = ops.cin_layer(xk, x0, cin[f"w{i}"])             # [B, K, D]
        pooled.append(out.sum(-1))
        xk, i = out, i + 1
    return torch.cat(pooled, dim=-1)


def head(cin: dict, mlp: dict, bias: torch.Tensor, emb: torch.Tensor,
         lin: torch.Tensor):
    """Logits from gathered embeddings ``emb`` [B, F, D] and the linear
    term ``lin`` [B]: the CIN, the MLP and the bias (``cin`` and ``mlp``
    dicts of their weights). Returns (logits [B], cin_feat
    [B, sum(cin_layers)])."""
    B, F, D = emb.shape
    cin_feat = cin_features(cin, emb)
    cin_logit = (cin_feat @ cin["out_w"])[:, 0]
    h, i = emb.reshape(B, F * D), 0
    while f"w{i}" in mlp:
        h = torch.relu(h @ mlp[f"w{i}"] + mlp[f"b{i}"])
        i += 1
    dnn_logit = (h @ mlp["out_w"])[:, 0]
    return lin + cin_logit + dnn_logit + bias[0], cin_feat


def embed(params: dict, cfg, ids):
    """Gather the embeddings [B, F, D] and the summed linear term [B] of
    int32 global row ids [B, F] (a tensor or a numpy array; moved to the
    parameters' device) through `gather_rows`."""
    ids = torch.as_tensor(ids, device=params["embed"].device)
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.dim() != 2 or ids.shape[1] != cfg.n_sparse:
        raise ValueError(f"ids must be [B, {cfg.n_sparse}], got "
                         f"{tuple(ids.shape)}")
    B, F = ids.shape
    flat = ids.reshape(-1).long()
    emb = gather_rows(params["embed"], flat).reshape(B, F, cfg.embed_dim)
    lin = gather_rows(params["linear"], flat).reshape(B, F).sum(-1)
    return emb, lin


def logits_and_cin(params: dict, cfg, ids):
    """(logits [B], pooled CIN features [B, sum(cin_layers)]) of int32
    ids [B, F] under ``params``, a nested dict of tensors as `param_tree`
    returns (leaves may require gradients)."""
    emb, lin = embed(params, cfg, ids)
    return head(params["cin"], params["mlp"], params["bias"], emb, lin)


def forward(params: dict, cfg, batch: dict) -> torch.Tensor:
    """The reference's `forward`: logits [B] of ``batch["ids"]``."""
    return logits_and_cin(params, cfg, batch["ids"])[0]


def loss_fn(params: dict, cfg, batch: dict) -> torch.Tensor:
    """The reference's `loss_fn`: mean binary cross-entropy of the logits
    against ``batch["labels"]``, in the numerically stable form."""
    logits = forward(params, cfg, batch)
    y = torch.as_tensor(batch["labels"], device=logits.device).float()
    loss = logits.clamp_min(0) - logits * y + torch.log1p(
        torch.exp(-logits.abs()))
    return loss.mean()


class XDeepFM(nn.Module):
    """The xDeepFM model on one device. ``device=None`` means the card (it
    raises where there is none); tests pass ``device="cpu"``. Weights are
    drawn as the reference's `init_params` draws them (zeros for biases,
    ``0.01 * normal`` for ``embed``, `trunc_normal` for the rest), from a
    `torch.Generator` on the device seeded with ``seed``. Its calls run
    the functional path over `param_tree(self)`."""

    def __init__(self, cfg: XDeepFMConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        defs = param_defs(cfg)
        register_params(self, defs, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            for path in sorted(defs):         # the reference's draw order
                p = self.get_parameter(path)
                if _is_bias(path):
                    p.zero_()
                elif path == "embed":
                    p.normal_(generator=gen).mul_(0.01)
                else:
                    p.copy_(trunc_normal(p.shape, gen))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_rows(self, ids):
        """`embed` under the module's weights."""
        return embed(param_tree(self), self.cfg, ids)

    def forward(self, ids, return_cin: bool = False):
        """Logits [B] of int32 ids [B, F]; with ``return_cin`` also the
        pooled CIN features [B, sum(cin_layers)]."""
        logits, cin_feat = logits_and_cin(param_tree(self), self.cfg, ids)
        return (logits, cin_feat) if return_cin else logits


def retrieval_scores_of(params: dict, cfg, query_ids, cand_emb):
    """One query against candidate vectors ``cand_emb`` [C, D] under
    ``params`` (the reference's `retrieval_scores(params, cfg, ...)`):
    the query is the mean of its field embeddings. Returns (scores [C],
    (top values, top indices)), the top 100 in descending order."""
    table = params["embed"]
    qi = torch.as_tensor(query_ids, device=table.device).reshape(-1).long()
    q = table.index_select(0, qi).reshape(-1, cfg.embed_dim)
    scores = cand_emb @ q.mean(0)
    top = torch.topk(scores, 100)
    return scores, (top.values, top.indices)


def retrieval_scores(model: XDeepFM, query_ids, cand_emb):
    """`retrieval_scores_of` under a module's weights."""
    return retrieval_scores_of(param_tree(model), model.cfg, query_ids,
                               cand_emb)


def params_to_numpy(params) -> dict:
    """The reference's nested dict of numpy float32 arrays, from an
    `XDeepFM` module or a nested dict of tensors (the inverse of
    `params_from_numpy`)."""
    return tree_to_numpy(params)


def params_from_numpy(cfg: XDeepFMConfig, tree: dict, device=None,
                      ) -> XDeepFM:
    """An `XDeepFM` holding the weights of ``tree``: the nested dict the
    reference's `init_params` returns, each leaf a numpy array. A missing
    key, an extra key or a shape that differs raises."""
    return load_numpy_tree(XDeepFM(cfg, device=device), param_defs(cfg),
                           tree)
