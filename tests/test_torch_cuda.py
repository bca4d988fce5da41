"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version on CUDA tensors, and the engine and builder on the card
against the same calls on the CPU. Marked `gpu`; they skip where
`torch.cuda.is_available()` is false. Run them on the card with

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.generators import erdos_renyi, random_queries, \
    scale_free
from repro_torch.core.query import DeviceQueryEngine, TRASH_LEVEL, \
    emit_ragged_worklist, ragged_worklist_len
from repro_torch.core.serve import WCSDServer
from repro_torch.core.wc_index_batched import build_wc_index_batched_packed
from repro_torch.kernels import _cuda
from repro_torch.kernels import frontier as kfr
from repro_torch.kernels import wcsd_query as kwq

pytestmark = pytest.mark.gpu

PACKED = ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
          "bucket_of", "slot_of")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def built(card):
    g = scale_free(400, m=4, num_levels=4, seed=0)
    idx, _ = build_wc_index_batched_packed(g, device="cpu")
    return g, idx


@pytest.mark.parametrize("lane", [128, 48])
def test_ragged_kernels_equal_plain(card, built, lane):
    g, idx = built
    eng = DeviceQueryEngine(idx, lane=lane, device=card)
    s, t, wl = random_queries(g, 1000, seed=lane)
    stq = eng._stage_ragged(s, t, wl)
    L = ragged_worklist_len(eng._tile_cnt_np, stq[0], stq[1])
    st = torch.from_numpy(stq).to(card)
    hub, dist, wlev, lo, hi, base, cnt = eng._arena
    q, si, ti, _ = emit_ragged_worklist(base, cnt, st[0], st[1],
                                        worklist_len=L)
    wq = torch.cat([st[2], torch.tensor([TRASH_LEVEL], dtype=torch.int32,
                                        device=card)])
    a = kwq.wcsd_query_ragged_cuda(hub, dist, wlev, lo, hi, q, si, ti, wq)
    b = kwq.wcsd_query_ragged_plain(hub, dist, wlev, q, si, ti, wq)
    assert torch.equal(a, b)
    rows = st.shape[1] + 1
    a = kwq.wcsd_profile_ragged_cuda(hub, dist, wlev, lo, hi, q, si, ti,
                                     rows, g.num_levels)
    b = kwq.wcsd_profile_ragged_plain(hub, dist, wlev, q, si, ti, rows,
                                      g.num_levels)
    assert torch.equal(a, b)


def test_frontier_kernels_equal_plain(card):
    rng = np.random.default_rng(0)
    g = erdos_renyi(300, 4.0, num_levels=4, seed=1)
    B, V, W1, cap = 16, g.num_nodes, 5, 12
    F = np.where(rng.random((B, V)) < 0.2, rng.integers(0, W1, (B, V)), -1)
    T = np.where(rng.random((B, V, W1)) < 0.5,
                 rng.integers(0, 9, (B, V, W1)), 1 << 30)
    n = rng.integers(0, cap + 1, V)
    col = np.arange(cap)[None, :]
    hub = np.where(col < n[:, None], np.sort(rng.integers(0, V, (V, cap)),
                                             1), -1)
    dist = np.where(col < n[:, None], rng.integers(1, 9, (V, cap)), 1 << 30)
    wlev = np.where(col < n[:, None], rng.integers(0, W1, (V, cap)), -1)
    c = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(card)
         for x in (F, T, hub, dist, wlev)]
    assert torch.equal(kfr.wc_prune_emit_batched_cuda(*c, 3),
                       kfr.wc_prune_emit_batched_plain(*c, 3))
    nbr, lvl = (torch.from_numpy(x).to(card) for x in g.padded_adjacency())
    rank = torch.from_numpy(rng.permutation(V).astype(np.int32)).to(card)
    rr = torch.from_numpy(np.concatenate([rng.integers(0, V, B - 2),
                                          [V + 1, V + 1]]).astype(
                                              np.int32)).to(card)
    R = torch.from_numpy(rng.integers(-1, W1, (B, V)).astype(
        np.int32)).to(card)
    for x, y in zip(kfr.wc_relax_batched_cuda(c[0], nbr, lvl, rank, rr, R),
                    kfr.wc_relax_batched_plain(c[0], nbr, lvl, rank, rr, R)):
        assert torch.equal(x, y)


def test_build_on_card_equals_cpu_and_serves(card, built):
    g, idx_cpu = built
    _cuda.reset_launch_counts()
    idx, _ = build_wc_index_batched_packed(g, device=card)
    assert _cuda.LAUNCHES["wc_prune_emit_batched"] > 0
    assert _cuda.LAUNCHES["wc_relax_batched"] > 0
    for name in PACKED:
        np.testing.assert_array_equal(getattr(idx.labels, name),
                                      getattr(idx_cpu.labels, name))
    s, t, wl = random_queries(g, 3000, seed=5)
    srv = WCSDServer(idx, max_batch=1024, device=card)
    before = _cuda.LAUNCHES["wcsd_query_ragged"]
    got = srv.query_many(s, t, wl)
    assert _cuda.LAUNCHES["wcsd_query_ragged"] - before == srv.stats.batches
    ref = WCSDServer(idx_cpu, max_batch=1024, device="cpu")
    np.testing.assert_array_equal(got, ref.query_many(s, t, wl))
    np.testing.assert_array_equal(srv.query_profile_many(s[:500], t[:500]),
                                  ref.query_profile_many(s[:500], t[:500]))
