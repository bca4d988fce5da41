"""The port's count of a step's work (`repro_torch.launch.op_analysis`)
against the reference's HLO analysis (`repro.launch.hlo_analysis.analyze`
of the XLA program it compiles on this CPU, one device), at each family's
smoke config: the same dry-run cell built by both packages' cell
builders at a small shape, counted on the port's side from meta tensors.

Bars: the LM family within 0.1% (measured: every cell equal but
qwen2-moe-a2.7b's train step, 1.000225: XLA folds the shared output
gate's contractions of size 1 into multiplies, which the port counts as
dots); GIN, PNA and GatedGCN within 1% (worst measured 1.002929,
GatedGCN); xDeepFM serving within 1% (measured 1.0). Two families miss
their bar by design (ROADMAP.md's divergences C2 and C3: the port's step
does other work than XLA's program, not more of it); their tests hold
the op-by-op difference found, so a change of either shows:

- C3, xDeepFM training (measured 1.293103): the port's CIN backward runs
  three contractions a layer (dx1 and dx0 through K11, dw through K12),
  the reference's XLA program two dots (dz = g W and dW = g^T z) and
  elementwise reductions for dx1 / dx0. With one 2 B H M K D a layer
  taken off, the port is within 1% of the reference (4,096 FLOPs over:
  XLA's folds of size-1 contractions).
- C2, NequIP (measured 0.956496 energy-only, 0.616568 with the force
  loss): the reference's layer scan transposes every tensor-product
  path in every layer (the cotangents the loss never reaches are
  materialized as zeros), where the port's loop over layers
  differentiates only the paths the loss reaches; and XLA folds
  contractions of size 1 into multiplies. The forward alone counts
  exactly the reference's: the port computes the edge geometry and the
  Y x Gaunt products once a forward (XLA hoists them out of the layer
  scan) and shares the product of the (0, l, l) and (l, l, 0) paths,
  whose tables are one matrix (XLA's common-subexpression pass). The
  test pins the two ratios and holds the forward to at most the
  reference's count.

The reference's MoE runs its `moe_ffn_chunked` route, the one it takes
without a device mesh and the one the port's cells take (the port has
no mesh there); the LM cells need a mesh in context for their sharding
constraints, so the test points `repro.models.transformer`'s
`moe_apply` at it.
"""
import dataclasses
import types

import jax
import pytest

from repro.configs import get_arch as ref_arch
from repro.configs import gnn_common as ref_gnc
from repro.configs import lm_common as ref_lmc
from repro.configs import xdeepfm_arch as ref_x
from repro.launch import hlo_analysis
from repro.models import moe as ref_moe
from repro.models import nequip as ref_nq
from repro.models import transformer as ref_T

from repro_torch.configs import get_arch
from repro_torch.configs import gnn_common as gnc
from repro_torch.configs import lm_common as lmc
from repro_torch.configs import xdeepfm_arch as tx
from repro_torch.launch.op_analysis import count_step
from repro_torch.models import nequip as nq

LM_BAR = 1e-3
OTHER_BAR = 1e-2
LM_SMOKE = {"t64": dict(kind="train", seq=64, batch=2),
            "p64": dict(kind="prefill", seq=64, batch=2),
            "d64": dict(kind="decode", seq=64, batch=2)}
GNN_TINY = dict(kind="train", n_nodes=40, n_edges_raw=60, d_feat=8,
                n_classes=3, graph_level=False, shard_nodes=False)
X_SMOKE = {"train_batch": dict(kind="train", batch=64),
           "serve_p99": dict(kind="serve", batch=64)}


def ref_flops(cell) -> float:
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        txt = jax.jit(cell.fn).lower(*cell.args).compile().as_text()
    return hlo_analysis.analyze(txt)["flops"]


def port_flops(cell) -> float:
    return count_step(cell.fn, cell.args)[1]["flops"]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "qwen2.5-14b"])
@pytest.mark.parametrize("shape", list(LM_SMOKE))
def test_lm_flops_equal_hlo(arch, shape, monkeypatch):
    for shapes in (ref_lmc.LM_SHAPES, lmc.LM_SHAPES):
        monkeypatch.setitem(shapes, shape, LM_SMOKE[shape])
    monkeypatch.setattr(ref_T, "moe_apply", ref_moe.moe_ffn_chunked)
    ref = ref_flops(ref_lmc.make_lm_cell(ref_arch(arch).smoke_config(),
                                         shape))
    got = port_flops(lmc.make_lm_cell(get_arch(arch).smoke_config(),
                                      shape))
    assert abs(got / ref - 1) <= LM_BAR, (got, ref)


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "gatedgcn"])
def test_gnn_flops_within_one_percent(arch, monkeypatch):
    for shapes in (ref_gnc.GNN_SHAPES, gnc.GNN_SHAPES):
        monkeypatch.setitem(shapes, "tiny", GNN_TINY)
    ref = ref_flops(ref_gnc.make_gnn_cell(ref_arch(arch).smoke_config(),
                                          "tiny"))
    got = port_flops(gnc.make_gnn_cell(get_arch(arch).smoke_config(),
                                       "tiny"))
    assert abs(got / ref - 1) <= OTHER_BAR, (got, ref)


def _xdeepfm_smoke(monkeypatch):
    for mod in (ref_x, tx):
        monkeypatch.setattr(mod, "get_config", mod.smoke_config)
        for k, v in X_SMOKE.items():
            monkeypatch.setitem(mod._SHAPE_SPECS, k, v)


def test_xdeepfm_serve_flops_within_one_percent(monkeypatch):
    _xdeepfm_smoke(monkeypatch)
    ref = ref_flops(ref_x.make_cell("serve_p99"))
    got = port_flops(tx.make_cell("serve_p99"))
    assert abs(got / ref - 1) <= OTHER_BAR, (got, ref)


def test_xdeepfm_train_flops_fault_c3(monkeypatch):
    """C3: one CIN contraction a layer over the reference's count."""
    _xdeepfm_smoke(monkeypatch)
    ref = ref_flops(ref_x.make_cell("train_batch"))
    got = port_flops(tx.make_cell("train_batch"))
    cfg = tx.smoke_config()
    extra = sum(tx.cin_flops(cfg, X_SMOKE["train_batch"]["batch"]))
    assert abs(got / ref - 1.293103) < 1e-6, (got, ref)
    assert abs((got - extra) / ref - 1) <= OTHER_BAR, (got, extra, ref)


@pytest.mark.parametrize("shape,ratio", [("tiny", 0.956496),
                                         ("molecule", 0.616568)])
def test_nequip_flops_fault_c2(shape, ratio, monkeypatch):
    """C2: the ratios the op-by-op difference of the module docstring
    gives (energy-only on a tiny graph; the force loss on molecule), and
    the forward (`energy_fn`) alone at most the reference's count."""
    for shapes in (ref_gnc.GNN_SHAPES, gnc.GNN_SHAPES):
        monkeypatch.setitem(shapes, "tiny", GNN_TINY)
    ref_cell = ref_gnc.make_nequip_cell(ref_arch("nequip").smoke_config(),
                                        shape)
    cell = gnc.make_nequip_cell(get_arch("nequip").smoke_config(), shape)
    ref = ref_flops(ref_cell)
    got = port_flops(cell)
    assert abs(got / ref - ratio) < 1e-6, (got, ref, got / ref)
    d_feat = gnc.GNN_SHAPES[shape]["d_feat"]
    rcfg = dataclasses.replace(ref_arch("nequip").smoke_config(),
                               d_feat=d_feat)
    tcfg = dataclasses.replace(get_arch("nequip").smoke_config(),
                               d_feat=d_feat)
    ng = gnc.n_graphs_of(tcfg, shape)
    ref_fwd = ref_flops(types.SimpleNamespace(
        fn=lambda p, b: ref_nq.energy_fn(p, rcfg, b, n_graphs=ng),
        args=(ref_cell.args[0], ref_cell.args[2])))
    fwd = count_step(lambda p, b: nq.energy_fn(p, tcfg, b, n_graphs=ng),
                     (cell.args[0], cell.args[2]))[1]["flops"]
    assert fwd <= ref_fwd, (fwd, ref_fwd)
