"""The port's examples (`examples/quickstart_torch.py`,
`examples/serve_wcsd_torch.py`, `examples/wcsd_features_gnn_torch.py`,
`examples/train_lm_torch.py`) run in-process on the CPU (the kernels' plain versions), their own
asserts included, at cut sizes (their defaults, the reference examples'
sizes, take ~100 s here): the quickstart's counts against the reference
package's builders on the same graph, the serving example's answers
against the reference's sequential index, the GNN example's labels and
distance encodings against the reference's `distance_encoding`, the LM
example's first loss against the reference example's on the same
weights."""
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


def test_train_lm_example_restarts_and_its_loss_falls(capsys):
    """At a tiny size (d 32, 2 layers, 30 steps of 4 x 64 tokens, lr
    1e-2): the loss falls, the injected failure at step 15 is survived by
    one restart from the step-0 checkpoint (saves come every 25 steps), and the first step's loss
    from the reference example's weights (`init_params(cfg, key(0))`,
    carried across) equals the reference example's first loss (its
    `loss_fn` on `TokenStream` batch 0) within 2e-3 (bf16 compute)."""
    import jax
    import jax.numpy as jnp
    from repro.data.lm import TokenStream
    from repro.models import transformer as RT
    args = ["--device", "cpu", "--lr", "1e-2", "--steps", "30",
            "--d-model", "32", "--layers", "2", "--seq", "64",
            "--batch", "4"]
    # the reference example's config at these arguments
    cfg = RT.LMConfig(name="lm-100m", n_layers=2, d_model=32, n_heads=8,
                      n_kv_heads=4, d_ff=128, vocab=32000, d_head=4,
                      tp_size=1)
    params = jax.jit(RT.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    batch = TokenStream(cfg.vocab, 64, 4, seed=0).next_batch()
    ref_loss = float(jax.jit(lambda p, b: RT.loss_fn(p, cfg, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    log = _load("train_lm_torch").main(
        args, init=jax.tree_util.tree_map(np.asarray, params))
    steps = [r for r in log if r["event"] == "step"]
    fails = [r for r in log if r["event"] == "failure"]
    assert len(fails) == 1 and fails[0]["step"] == 15
    assert [r["step"] for r in steps] == list(range(15)) + list(range(30))
    assert steps[0]["loss"] == pytest.approx(ref_loss, rel=2e-3)
    first = np.mean([r["loss"] for r in steps[:5]])
    last = np.mean([r["loss"] for r in steps[-5:]])
    # the replayed steps repeat the first ones bit for bit
    assert [r["loss"] for r in steps[15:30]] == [r["loss"]
                                                 for r in steps[:15]]
    assert last < first - 0.3, (first, last)
    assert "1 restart(s)" in capsys.readouterr().out


CARD_ARGS = {"quickstart_torch": ["--grid", "4"],
             "serve_wcsd_torch": ["--nodes", "40", "--queries", "10"],
             "wcsd_features_gnn_torch": ["--nodes", "40", "--steps", "1"],
             "train_lm_torch": ["--steps", "1", "--d-model", "16",
                                "--layers", "1", "--seq", "8",
                                "--batch", "1"]}


@pytest.mark.parametrize("name", list(CARD_ARGS))
def test_examples_default_to_the_card(name):
    """With no ``--device`` an example runs on the card, and raises where
    there is none (no fallback to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(CARD_ARGS[name])
