"""Host layer of the PyTorch port against the reference package: graphs,
generators (networkx-free `scale_free` included), orderings, dominance,
the packed label store and the lane-tiled arena — byte for byte."""
import numpy as np
import pytest

from _torch_parity import (ARENA_FIELDS, GRAPH_FIELDS, PACKED_FIELDS,
                           assert_same_array, assert_same_fields,
                           graph_arrays, port_graph, port_index)
from repro.core import dominance as jdom
from repro.core import generators as jgen
from repro.core import ordering as jord
from repro.core.graph import expand_frontier_csr as j_expand
from repro.core.ref import wcsd_bfs as j_bfs
from repro.core.wc_index import PackedLabelsBuilder as JBuilder
from repro.core.wc_index import build_wc_index
from repro_torch.core import dominance as tdom
from repro_torch.core import generators as tgen
from repro_torch.core import ordering as tord
from repro_torch.core.graph import expand_frontier_csr as t_expand
from repro_torch.core.ref import wcsd_bfs as t_bfs
from repro_torch.core.wc_index import PackedLabelsBuilder as TBuilder


def _same_graph(gj, gt):
    assert gj.num_nodes == gt.num_nodes and gj.version == gt.version
    assert_same_fields(gj, gt, GRAPH_FIELDS)


@pytest.mark.parametrize("n,m,seed,levels", [
    (10, 2, 0, 3), (50, 1, 3, 2), (200, 4, 0, 3), (300, 3, 7, 5),
    (1000, 5, 123, 9)])
def test_scale_free_matches_networkx_reference(n, m, seed, levels):
    """The pure-Python Barabási–Albert generator reproduces networkx's
    graph, so `scale_free` is byte-identical without networkx."""
    _same_graph(jgen.scale_free(n, m=m, num_levels=levels, seed=seed),
                tgen.scale_free(n, m=m, num_levels=levels, seed=seed))


@pytest.mark.parametrize("family,kw", [
    ("road_grid", dict(rows=9, cols=13, num_levels=4, seed=5)),
    ("erdos_renyi", dict(num_nodes=70, avg_degree=3.5, num_levels=3,
                         seed=11))])
def test_other_generators_match(family, kw):
    _same_graph(getattr(jgen, family)(**kw), getattr(tgen, family)(**kw))


def test_random_queries_match():
    g = jgen.erdos_renyi(60, 3.0, num_levels=4, seed=1)
    for a, b in zip(jgen.random_queries(g, 333, seed=9),
                    tgen.random_queries(port_graph(g), 333, seed=9)):
        assert_same_array(a, b)


def test_graph_from_arrays_round_trip():
    g = jgen.scale_free(80, m=3, num_levels=3, seed=2)
    gt = port_graph(g)
    _same_graph(g, gt)
    assert gt.num_levels == g.num_levels and gt.num_edges == g.num_edges


@pytest.mark.parametrize("max_deg", [None, 3])
def test_padded_adjacency_matches(max_deg):
    g = jgen.scale_free(150, m=3, num_levels=3, seed=4)
    for a, b in zip(g.padded_adjacency(max_deg),
                    port_graph(g).padded_adjacency(max_deg)):
        assert_same_array(a, b)


@pytest.mark.parametrize("name", ["degree", "treedec", "hybrid"])
def test_orderings_match(name):
    g = jgen.scale_free(120, m=3, num_levels=3, seed=6)
    assert_same_array(jord.make_order(g, name),
                      tord.make_order(port_graph(g), name))


def test_expand_frontier_and_bfs_match():
    g = jgen.erdos_renyi(80, 3.0, num_levels=3, seed=8)
    gt = port_graph(g)
    nodes = np.array([0, 5, 17, 42, 79], dtype=np.int32)
    for a, b in zip(j_expand(g, nodes), t_expand(gt, nodes)):
        assert_same_array(a, b)
    rng = np.random.default_rng(0)
    for _ in range(40):
        s, t = (int(x) for x in rng.integers(0, 80, 2))
        w = int(rng.integers(0, 4))
        assert j_bfs(g, s, t, w) == t_bfs(gt, s, t, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_csr_emit_matches(seed):
    rng = np.random.default_rng(seed)
    n, V = 400, 30
    v = rng.integers(0, V, n)
    hub = rng.integers(0, V, n)
    d = rng.integers(0, 8, n)
    w = rng.integers(0, 5, n)
    for a, b in zip(jdom.pareto_csr_emit(v, hub, d, w, V),
                    tdom.pareto_csr_emit(v, hub, d, w, V)):
        assert_same_array(a, b)
    assert_same_array(jdom.pareto_filter_grouped(hub, d, w),
                      tdom.pareto_filter_grouped(hub, d, w))


def test_packed_labels_builder_finalize_matches():
    rng = np.random.default_rng(3)
    V, W = 25, 3
    jb, tb = JBuilder(V), TBuilder(V)
    for start in range(0, V, 5):  # rank batches, ascending hub ranks
        n = 40
        v = np.sort(rng.integers(0, V, n))
        hub = rng.integers(start, start + 5, n)
        d = rng.integers(1, 6, n)
        w = rng.integers(0, W, n)
        o = np.lexsort((d, hub, v))
        for b in (jb, tb):
            b.append_batch(v[o], hub[o], d[o], w[o])
    rank = rng.permutation(V).astype(np.int32)
    (pj, rj), (pt, rt) = (b.finalize(rank, W) for b in (jb, tb))
    assert rj == rt
    assert_same_fields(pj, pt, PACKED_FIELDS)


@pytest.mark.parametrize("lane", [128, 48])
def test_packed_labels_and_arena_match(lane):
    """The reference index's fields rebuild the port's PackedLabels (bucket
    tables included) and LabelArena identically, at lane 128 and lane 48."""
    g = jgen.scale_free(150, m=4, num_levels=3, seed=0)
    idx = build_wc_index(g, ordering="degree")
    jp = idx.packed(lane=lane)
    tp = port_index(idx, lane=lane).packed(lane=lane)
    assert_same_fields(jp, tp, PACKED_FIELDS)
    assert [list(a) for a in jp.bucket_vertices] == \
        [list(a) for a in tp.bucket_vertices]
    ja, ta = jp.arena(lane=lane), tp.arena(lane=lane)
    assert_same_fields(ja, ta, ARENA_FIELDS)
    assert ja.memory_bytes() == ta.memory_bytes()
    assert ja.checksums() == ta.checksums()


def test_arena_integrity_check_raises_on_corruption():
    from repro_torch.core.resilience import IndexIntegrityError
    g = jgen.erdos_renyi(40, 3.0, num_levels=3, seed=1)
    ar = port_index(build_wc_index(g)).packed().arena()
    ar.verify_integrity()
    ar.dist[0, 0] ^= 1
    with pytest.raises(IndexIntegrityError):
        ar.verify_integrity()


def test_graph_arrays_helper_covers_every_field():
    g = jgen.erdos_renyi(20, 2.0, num_levels=2, seed=0)
    assert set(graph_arrays(g)) >= set(GRAPH_FIELDS) | {"num_nodes"}
