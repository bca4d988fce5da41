"""Graph data pipeline of the port: full-batch loaders, batched small
graphs, a CSR fanout neighbor sampler (GraphSAGE-style, the minibatch_lg
shape), and the WC-INDEX integration: quality-constrained distance
encodings as node features, the paper's technique feeding the GNN.

`NeighborSampler`, `pad_block`, `synthetic_node_task` and
`synthetic_molecules` are host numpy, a copy of the reference's
`data/graphs.py`: the same seed gives byte-identical arrays.
`distance_encoding` answers every query through one `DeviceQueryEngine`
(CSR arena, ragged dispatch): one K1 launch per flush on the card, the
engine's plain path with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph

ENCODING_FLUSH = 1 << 18   # queries per engine call of `distance_encoding`


# ----------------------------------------------------------- fanout sampler
class NeighborSampler:
    """Uniform fanout sampling over CSR adjacency, numpy-vectorized.

    sample(seeds, fanouts) returns a *block*: the union node set (seeds
    first), a remapped edge list (src/dst into the union set), and the seed
    count — the standard GraphSAGE block layout."""

    def __init__(self, g: Graph, seed: int = 0):
        self.g = g
        self.rng = np.random.default_rng(seed)

    def _sample_layer(self, frontier: np.ndarray, fanout: int):
        g = self.g
        deg = (g.indptr[frontier + 1] - g.indptr[frontier]).astype(np.int64)
        # with replacement when deg > 0 (uniform), skip deg == 0
        has = deg > 0
        f = frontier[has]
        d = deg[has]
        if len(f) == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z
        offs = self.rng.integers(0, d[:, None], size=(len(f), fanout))
        eidx = self.g.indptr[f][:, None] + offs
        nbrs = self.g.nbr[eidx]                        # [F, fanout]
        src = nbrs.reshape(-1).astype(np.int32)
        dst = np.repeat(f.astype(np.int32), fanout)
        return src, dst

    def sample(self, seeds: np.ndarray, fanouts: list[int]) -> dict:
        seeds = np.asarray(seeds, dtype=np.int32)
        all_src, all_dst = [], []
        frontier = seeds
        for fo in fanouts:
            src, dst = self._sample_layer(frontier, fo)
            all_src.append(src)
            all_dst.append(dst)
            frontier = np.unique(src)
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int32)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int32)
        nodes, inv = np.unique(np.concatenate([seeds, src, dst]),
                               return_inverse=True)
        # remap so seeds occupy the first len(seeds) slots
        order = np.concatenate([
            np.searchsorted(nodes, seeds),
            np.setdiff1d(np.arange(len(nodes)),
                         np.searchsorted(nodes, seeds))])
        pos = np.empty(len(nodes), dtype=np.int64)
        pos[order] = np.arange(len(nodes))
        k = len(seeds)
        return {
            "nodes": nodes[order].astype(np.int32),
            "edges_src": pos[np.searchsorted(nodes, src)].astype(np.int32),
            "edges_dst": pos[np.searchsorted(nodes, dst)].astype(np.int32),
            "num_seeds": k,
        }


def pad_block(block: dict, num_nodes: int, num_edges: int) -> dict:
    """Pad a sampled block to static shapes (drop overflow, pad with a
    sink node that receives no gradients)."""
    n = len(block["nodes"])
    out = dict(block)
    out["nodes"] = np.resize(block["nodes"], num_nodes)
    if n < num_nodes:
        out["nodes"][n:] = 0
    src = block["edges_src"][:num_edges]
    dst = block["edges_dst"][:num_edges]
    pad_e = num_edges - len(src)
    if pad_e > 0:
        src = np.concatenate([src, np.full(pad_e, num_nodes - 1, np.int32)])
        dst = np.concatenate([dst, np.full(pad_e, num_nodes - 1, np.int32)])
    out["edges_src"], out["edges_dst"] = src, dst
    return out


# ------------------------------------------------- WC-INDEX feature plug-in
def distance_encoding(idx, nodes: np.ndarray, landmarks: np.ndarray,
                      w_levels: list[int], clip: int = 32, device=None,
                      engine=None) -> np.ndarray:
    """Quality-constrained distance encodings: feature[i, (j, l)] =
    dist_w_l(node_i, landmark_j), clipped at ``clip``; float32 [n,
    |levels| x |landmarks|] in the reference's column order (level-major).

    ``idx`` is a `WCIndex` or `PackedWCIndex`. Every query goes through
    one `DeviceQueryEngine(layout="csr", dispatch="ragged")` on
    ``device`` (None: the card, raising where there is none), in flushes
    of `ENCODING_FLUSH` queries: one K1 launch each on the card.
    ``engine`` reuses an engine built over ``idx``."""
    if engine is None:
        from ..core.query import DeviceQueryEngine
        engine = DeviceQueryEngine(idx, layout="csr", dispatch="ragged",
                                   device=device)
    nodes = np.asarray(nodes, dtype=np.int32)
    n, cols = len(nodes), len(w_levels) * len(landmarks)
    # column by column: level-major, then landmark, then node
    s = np.tile(nodes, cols)
    t = np.repeat(np.tile(np.asarray(landmarks, np.int32), len(w_levels)), n)
    wl = np.repeat(np.asarray(w_levels, np.int32), len(landmarks) * n)
    handles = [engine.query_async(s[i:i + ENCODING_FLUSH],
                                  t[i:i + ENCODING_FLUSH],
                                  wl[i:i + ENCODING_FLUSH])
               for i in range(0, len(s), ENCODING_FLUSH)]
    d = (np.concatenate([h.wait() for h in handles]) if handles
         else np.zeros(0, np.int32))
    d = d.reshape(cols, n).T
    return np.ascontiguousarray(np.minimum(d, clip), dtype=np.float32)


# ------------------------------------------------------ synthetic features
def synthetic_node_task(g: Graph, d_feat: int, n_classes: int,
                        seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "feat": rng.standard_normal((g.num_nodes, d_feat)).astype(np.float32),
        "edges_src": g.edges_src.astype(np.int32),
        "edges_dst": g.edges_dst.astype(np.int32),
        "labels": rng.integers(0, n_classes, g.num_nodes).astype(np.int32),
    }


def synthetic_molecules(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                        seed: int = 0) -> dict:
    """Batched small graphs, flattened with graph_id (molecule shape)."""
    rng = np.random.default_rng(seed)
    N = batch * n_nodes
    src = (rng.integers(0, n_nodes, (batch, n_edges))
           + n_nodes * np.arange(batch)[:, None]).reshape(-1)
    dst = (rng.integers(0, n_nodes, (batch, n_edges))
           + n_nodes * np.arange(batch)[:, None]).reshape(-1)
    return {
        "feat": rng.standard_normal((N, d_feat)).astype(np.float32),
        "pos": (rng.standard_normal((N, 3)) * 2).astype(np.float32),
        "edges_src": src.astype(np.int32),
        "edges_dst": dst.astype(np.int32),
        "graph_id": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "labels": rng.integers(0, 2, batch).astype(np.int32),
        "energy": rng.standard_normal(batch).astype(np.float32),
        "forces": rng.standard_normal((N, 3)).astype(np.float32),
    }
