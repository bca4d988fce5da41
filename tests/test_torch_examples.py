"""The port's examples (`examples/quickstart_torch.py`,
`examples/serve_wcsd_torch.py`, `examples/wcsd_features_gnn_torch.py`)
run in-process on the CPU (the kernels' plain versions), their own
asserts included, at cut sizes (their defaults, the reference examples'
sizes, take ~100 s here): the quickstart's counts against the reference
package's builders on the same graph, the serving example's answers
against the reference's sequential index, the GNN example's labels and
distance encodings against the reference's `distance_encoding`."""
import importlib.util
import os

import numpy as np
import pytest

from repro.core import build_wc_index, build_wc_index_batched, clean_index
from repro.core.baselines import NaiveIndex
from repro.core.generators import random_queries, road_grid, scale_free
from repro.data.graphs import distance_encoding

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_counts_equal_the_reference_builders(capsys):
    got = _load("quickstart_torch").main(["--device", "cpu", "--grid", "16"])
    g = road_grid(16, 16, num_levels=5, seed=0)
    idx = build_wc_index(g, ordering="hybrid")
    bat, stats = build_wc_index_batched(g, ordering="hybrid", batch_size=64)
    cleaned, removed = clean_index(bat)
    assert got == {"entries": idx.size_entries(),
                   "naive_entries": NaiveIndex.build(g).size_entries(),
                   "rounds": stats["rounds"],
                   "batched_entries": bat.size_entries(),
                   "removed": removed,
                   "cleaned_entries": cleaned.size_entries()}
    assert got["cleaned_entries"] == got["entries"]
    out = capsys.readouterr().out
    assert "device batch on cpu agrees" in out


def test_serve_example_answers_equal_the_reference_index(capsys):
    got = _load("serve_wcsd_torch").main(
        ["--device", "cpu", "--nodes", "600", "--queries", "3000"])
    g = scale_free(600, 4, num_levels=5, seed=0)
    s, t, wl = random_queries(g, 3000, seed=1)
    idx = build_wc_index(g)
    np.testing.assert_array_equal(got["answers"], idx.query_batch(s, t, wl))
    prof = got["profiles"]
    assert prof.shape == (2000, g.num_levels + 1)
    for w in range(g.num_levels + 1):
        np.testing.assert_array_equal(
            prof[:, w], idx.query_batch(s[:2000], t[:2000],
                                        np.full(2000, w, np.int32)))
    out = capsys.readouterr().out
    for tag in ("[padded ]", "[csr    ]", "[sharded]",
                "profile spot checks vs BFS oracle pass"):
        assert tag in out


def test_gnn_features_example_encodings_equal_the_reference(capsys):
    """The GIN with WC-INDEX encodings beats the bare features (the
    example's assert) at 300 vertices and 60 steps; its labels and
    standardized encodings equal those from the reference's index."""
    got = _load("wcsd_features_gnn_torch").main(
        ["--device", "cpu", "--nodes", "300", "--steps", "60"])
    g = scale_free(300, 3, num_levels=4, seed=0)
    idx = build_wc_index(g)
    nodes, hubs = np.arange(g.num_nodes), np.array([0, 1])
    d = distance_encoding(idx, nodes, hubs, w_levels=[2])
    np.testing.assert_array_equal(got["labels"],
                                  (d.min(axis=1) <= 3).astype(np.int32))
    enc = distance_encoding(idx, nodes, hubs, w_levels=[0, 2])
    enc = (enc - enc.mean(0)) / (enc.std(0) + 1e-6)
    np.testing.assert_array_equal(got["encodings"], enc)
    assert got["acc_wcsd"] > got["acc_base"]
    assert "WC-INDEX features improve the GNN" in capsys.readouterr().out


CARD_ARGS = {"quickstart_torch": ["--grid", "4"],
             "serve_wcsd_torch": ["--nodes", "40", "--queries", "10"],
             "wcsd_features_gnn_torch": ["--nodes", "40", "--steps", "1"]}


@pytest.mark.parametrize("name", list(CARD_ARGS))
def test_examples_default_to_the_card(name):
    """With no ``--device`` an example runs on the card, and raises where
    there is none (no fallback to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(CARD_ARGS[name])
