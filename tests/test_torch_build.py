"""The port's device-resident builder (`build_wc_index_batched_packed`,
run on the CPU through the plain versions of K3/K4) against the reference
builder with its Pallas kernels in interpret mode: byte-identical
`PackedLabels` and equal `rounds` / `raw_entries` / `dominated_removed`
for the same graph, order and batch size. Then the slice as a whole: the
port builds and serves, and its answers equal the reference's build +
serve and the BFS grid."""
import numpy as np
import pytest

from _torch_parity import PACKED_FIELDS, assert_same_array, \
    assert_same_fields, port_graph
from repro.core import generators as jgen
from repro.core.baselines import constrained_distance_grid
from repro.core.serve import WCSDServer as JServer
from repro.core.wc_index_batched import \
    build_wc_index_batched_packed as j_build
from repro_torch.core import generators as tgen
from repro_torch.core.serve import WCSDServer as TServer
from repro_torch.core.wc_index_batched import \
    build_wc_index_batched_packed as t_build

GRAPHS = {
    "scale_free-160": lambda m: m.scale_free(160, m=4, num_levels=3, seed=0),
    "road_grid-10x12": lambda m: m.road_grid(10, 12, num_levels=4, seed=2),
}
STATS = ("rounds", "raw_entries", "dominated_removed", "entries",
         "batch_size", "host_array_syncs", "host_scalar_syncs")


@pytest.fixture(scope="module")
def builds():
    """Each graph built once by each builder (the reference with its
    Pallas round kernels in interpret mode)."""
    out = {}
    for name, make in GRAPHS.items():
        gj = make(jgen)
        ij, sj = j_build(gj, batch_size=32, use_kernel=True, interpret=True)
        it, st = t_build(port_graph(gj), batch_size=32, device="cpu")
        out[name] = (gj, ij, sj, it, st)
    return out


@pytest.mark.parametrize("name", list(GRAPHS))
def test_build_matches_reference_byte_for_byte(builds, name):
    gj, ij, sj, it, st = builds[name]
    assert_same_fields(ij.labels, it.labels, PACKED_FIELDS)
    assert_same_array(ij.order, it.order)
    assert_same_array(ij.rank, it.rank)
    assert_same_array(ij.levels, it.levels)
    for k in STATS:
        assert sj[k] == st[k], k


@pytest.mark.parametrize("name", list(GRAPHS))
def test_slice_build_then_serve_matches_reference_and_bfs(builds, name):
    """Graph -> port build -> port server == reference build -> reference
    server == BFS grid, for every (s, t, w) and every profile."""
    gj, ij, _, it, _ = builds[name]
    D = constrained_distance_grid(gj)
    V, W = gj.num_nodes, gj.num_levels
    rng = np.random.default_rng(1)
    n = 600
    s = rng.integers(0, V, n).astype(np.int32)
    t = rng.integers(0, V, n).astype(np.int32)
    wl = rng.integers(0, W + 1, n).astype(np.int32)
    srv = TServer(it, max_batch=128, device="cpu")
    ref = JServer(ij, max_batch=128, layout="csr", use_pallas=False)
    got = srv.query_many(s, t, wl)
    assert_same_array(got, D[s, t, wl])
    assert_same_array(got, ref.query_many(s, t, wl))
    prof = srv.query_profile_many(s[:200], t[:200])
    assert_same_array(prof, D[s[:200], t[:200], :])
    assert_same_array(prof, ref.query_profile_many(s[:200], t[:200]))


@pytest.mark.parametrize("batch_size,minimalize", [(8, True), (16, False)])
def test_build_options_match_reference(batch_size, minimalize):
    """Other batch sizes, and the un-minimalized store (no Pareto pass),
    against the reference's plain (jnp) round path."""
    gj = jgen.erdos_renyi(60, 3.0, num_levels=3, seed=4)
    ij, sj = j_build(gj, batch_size=batch_size, minimalize=minimalize,
                     use_kernel=False)
    it, st = t_build(port_graph(gj), batch_size=batch_size,
                     minimalize=minimalize, device="cpu")
    assert_same_fields(ij.labels, it.labels, PACKED_FIELDS)
    for k in STATS:
        assert sj[k] == st[k], k


def test_port_generated_graph_builds_same_index():
    """A graph the port generates itself (networkx-free) builds the same
    index as the reference's graph from the same seed."""
    gj = jgen.scale_free(100, m=3, num_levels=3, seed=9)
    gt = tgen.scale_free(100, m=3, num_levels=3, seed=9)
    ij, _ = j_build(gj, batch_size=32, use_kernel=False)
    it, _ = t_build(gt, batch_size=32, device="cpu")
    assert_same_fields(ij.labels, it.labels, PACKED_FIELDS)
