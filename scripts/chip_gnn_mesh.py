#!/usr/bin/env python3
"""The graph family's ogb_products cells over four cards.

    python3 scripts/chip_gnn_mesh.py [--out FILE] [--cells gin,pna,gatedgcn,nequip]
        [--steps N] [--no-check]

Needs four CUDA devices, a ("data",) 4 mesh, card k shard k. For each
cell ``--cells`` names (all by default): the arch at `get_config()`
width and depth sized by `shape_config(cfg, "ogb_products")` (bf16 for
the three GNNs, float32 for NequIP), trained on `cell_batch(
"ogb_products", seed=0)` (N = 2,449,408, E = 123,718,656) placed by the
cell's batch specs (the edges over "data", and for the GNNs the node
rows and labels too; NequIP's node arrays replicated), the parameters
and AdamW moments replicated (`gnn_common.shard_params`): one warm-up
step, then ``--steps`` timed steps (default 2; NequIP 1), each between
syncs of every card; the median against the per-card bound (the dry
run's one-card bound of the cell, `launch.dryrun.count_cell` on meta
tensors at `launch.roofline`'s peaks, over four: the even split, no
collective term); each card's peak; one more step traced
(`torch.profiler`: busy ms and idle share a card, the cross-card copies'
ms), in which the bytes each card receives from the others are counted
(`trace_step`).

The check (``--no-check`` skips it): at the smoke's check-A graph
(`chip_smoke.GNN_MESH_EXACT`: N = 2^17, E = 2^21, `BIG_GRAPH` 2^16 and
`EDGE_CHUNK` 2^17, so blocks of 4 layers recompute and each shard's
edges run in 4 chunks; four logical shards of PNA at 2^19 x 2^23 in
float32 would need ~75 GB of recomputed node activations on card 0) in
float32, two steps of every arch over the four cards against four
logical shards of card 0: the losses, parameters and moments bit for
bit (every cross-card sum has a fixed order).

A cell that fails is a miss and the next one still runs. No kernel of
the port runs (the counts stay 0). Prints one JSON line (appended to
``--out``) with the cards' names and power limits and every miss; exits
non-zero if there was one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import chip_smoke as cs  # noqa: E402  (puts the checkout's src/ on the path)

CARDS = 4
SHAPE = "ogb_products"
CELLS = ("gin", "pna", "gatedgcn", "nequip")
ARCH = {"gin": "gin-tu", "pna": "pna", "gatedgcn": "gatedgcn",
        "nequip": "nequip"}
CHECK_STEPS = 2
MISSES: list = []


def config(cell: str):
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as GC
    return GC.shape_config(get_arch(ARCH[cell]).get_config(), SHAPE)


def per_card_bound(cfg) -> dict:
    """The cell's one-card bound (its step counted on meta tensors) over
    the cards: the dry run's even split, no collective term."""
    from repro_torch.configs import gnn_common as GC
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.roofline import bound_s
    from repro_torch.models import nequip as NQ
    cell = (GC.make_nequip_cell(cfg, SHAPE) if isinstance(
        cfg, NQ.NequIPConfig) else GC.make_gnn_cell(cfg, SHAPE))
    counts, _ = count_cell(cell)
    one, by = bound_s(counts["flops"], counts["int_ops"],
                      counts["moved_bytes"])
    return {"one_card_bound_s": one, "bound_by": by,
            "per_card_bound_s": one / CARDS, "flops": counts["flops"],
            "moved_bytes": counts["moved_bytes"],
            "count_s": counts["count_s"]}


def trace_step(fn, cards) -> dict:
    """One call of ``fn`` under a `torch.profiler` CUDA trace: kernel ms
    by card, the cross-card copies' ms (Memcpy PtoP) by card, the
    call's wall ms; and the bytes each card received from another card
    through `Tensor.to` (every cross-card sum and gather of the mesh
    path moves its tensors so, in the backward too; autograd's own
    copies of a scalar loss are not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    received: dict = {}
    to = torch.Tensor.to

    def counted(self, *a, **k):
        out = to(self, *a, **k)
        if out.device != self.device and out.is_cuda and self.is_cuda:
            received[out.device.index] = received.get(
                out.device.index, 0) + out.numel() * out.element_size()
        return out

    cs.sync_all(cards)
    torch.Tensor.to = counted
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            cs.sync_all(cards)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.Tensor.to = to
    busy: dict = {}
    peer: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy[e.device_index] = busy.get(e.device_index, 0.0) + ms
            if "PtoP" in e.name:
                peer[e.device_index] = peer.get(e.device_index, 0.0) + ms
    return {"wall_ms": wall,
            "busy_ms": {str(k): v for k, v in sorted(busy.items())},
            "idle_share": {str(k): max(0.0, 1 - v / wall)
                           for k, v in sorted(busy.items())},
            "peer_copy_ms": {str(k): v for k, v in sorted(peer.items())},
            "received_gb": {str(k): v / 1e9
                            for k, v in sorted(received.items())}}


def run_cell(cell: str, cards, steps: int) -> dict:
    """One ogb_products cell at full size over the cards (see the
    module's note)."""
    import torch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.launch.mesh import make_serving_mesh, place_batch
    from repro_torch.models import gnn as G
    from repro_torch.models import nequip as NQ
    from repro_torch.train import optim as O
    cfg = config(cell)
    rec = {"arch": ARCH[cell], "shape": SHAPE,
           "dtype": getattr(cfg, "compute_dtype", "float32")}
    rec.update(per_card_bound(cfg))
    t0 = time.perf_counter()
    batch = GC.cell_batch(SHAPE, seed=0)
    rec["batch_s"] = time.perf_counter() - t0
    N, E = batch["feat"].shape[0], batch["edges_src"].shape[0]
    rec.update(nodes=N, edges=E, edges_a_card=E // CARDS)
    mesh = make_serving_mesh(cards)
    for c in cards:
        torch.empty(0, device=c)
        torch.cuda.reset_peak_memory_stats(c)
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    mod = NQ if isinstance(cfg, NQ.NequIPConfig) else G
    params = GC.shard_params(mod.init_params(
        cfg, torch.Generator(cards[0]).manual_seed(0)), cfg, mesh)
    opt = O.init_opt_state(GC.TRAIN_OPT, params)
    t0 = time.perf_counter()
    placed = place_batch(batch, mesh, GC.batch_specs(cfg, SHAPE))
    cs.sync_all(cards)
    rec["place_s"] = time.perf_counter() - t0
    del batch
    step = GC.make_train_step_for(cfg, SHAPE, mesh=mesh)
    secs, losses = [], []
    for i in range(1 + steps):
        cs.sync_all(cards)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, placed)
        losses.append(float(met["loss"]))
        cs.sync_all(cards)
        secs.append(time.perf_counter() - t0)
        cs.progress(f"{cell} ogb_products step {i}: {secs[-1]:.3f} s, "
                    f"loss {losses[-1]:.6g}")
    rec.update(warmup_s=secs[0], step_s=secs[1:], losses=losses,
               median_step_s=float(np.median(secs[1:])),
               peak_gb={str(c): (torch.cuda.max_memory_allocated(c)
                                 - base[c]) / 1e9 for c in cards})
    rec["step_over_bound"] = rec["median_step_s"] / rec["per_card_bound_s"]
    if not np.isfinite(losses).all():
        MISSES.append(f"{cell}: a loss is not finite: {losses}")
    rec["traced_step"] = trace_step(lambda: step(params, opt, placed), cards)
    del params, opt, placed, step
    torch.cuda.empty_cache()
    return rec


def check(cells, cards) -> dict:
    """The four cards against four logical shards of card 0, at the
    smoke's graph in float32, two steps of each arch: bit for bit."""
    import torch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.launch.mesh import (Sharded, join_leaf,
                                         make_serving_mesh, place_batch)
    from repro_torch.models import common as C
    from repro_torch.models import gnn as G
    from repro_torch.models import nequip as NQ
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import map_sharded
    out = {}
    ex = cs.GNN_MESH_EXACT
    with cs.gnn_mesh_sizes(ex["big_graph"], ex["chunk"]):
        base = config("gin")
        batch = cs.gnn_mesh_graph(base.d_feat, base.n_classes, seed=1,
                                  nodes=ex["nodes"],
                                  raw_edges=ex["raw_edges"])
        for cell in cells:
            cfg = config(cell)
            if hasattr(cfg, "compute_dtype"):
                cfg = dataclasses.replace(cfg, compute_dtype="float32")
            mod = NQ if isinstance(cfg, NQ.NequIPConfig) else G
            specs = GC.batch_specs(cfg, SHAPE)
            runs = {}
            for name, devs in (("four_cards", cards),
                               ("card0_logical", [cards[0]] * CARDS)):
                mesh = make_serving_mesh(devs)
                p = GC.shard_params(mod.init_params(
                    cfg, torch.Generator(cards[0]).manual_seed(0)), cfg, mesh)
                o = O.init_opt_state(GC.TRAIN_OPT, p)
                placed = place_batch(batch, mesh, specs)
                step = make_train_step(
                    cs.gnn_mesh_loss(cfg, len(batch["edges_src"])),
                    GC.TRAIN_OPT, mesh=mesh, batch_specs=specs,
                    one_thread=True)
                losses, secs = [], []
                for _ in range(CHECK_STEPS):
                    cs.sync_all(devs)
                    t0 = time.perf_counter()
                    p, o, met = step(p, o, placed)
                    losses.append(float(met["loss"]))
                    cs.sync_all(devs)
                    secs.append(time.perf_counter() - t0)
                whole = C.flatten_params(map_sharded(
                    lambda x: (join_leaf(x) if isinstance(x, Sharded)
                               else x).to("cpu"), {"p": p, "m": o.m,
                                                   "v": o.v}))
                runs[name] = {"losses": losses, "step_s": secs,
                              "state": whole}
                del p, o, placed, step
                torch.cuda.empty_cache()
            a, b = runs["four_cards"], runs["card0_logical"]
            differ = [k for k in a["state"]
                      if not torch.equal(a["state"][k], b["state"][k])]
            equal = a["losses"] == b["losses"] and not differ
            out[cell] = {"losses": a["losses"],
                         "card0_losses": b["losses"],
                         "four_cards_step_s": a["step_s"],
                         "card0_logical_step_s": b["step_s"],
                         "bit_equal": equal, "differing_leaves": differ}
            cs.progress(f"check {cell}: four cards vs card 0 logical, "
                        f"bit equal {equal}")
            if not equal:
                MISSES.append(f"check {cell}: four cards differ from four "
                              f"logical shards of card 0 in {differ} / "
                              f"losses {a['losses']} vs {b['losses']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    cells = args.cells.split(",")
    if set(cells) - set(CELLS):
        ap.error(f"--cells takes {', '.join(CELLS)}")
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < CARDS:
        print(f"chip_gnn_mesh: needs {CARDS} CUDA devices, found {n}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(CARDS)]
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rec = {"cells": {}}
    for cell in cells:
        # a cell that fails is a miss (the script exits non-zero); the
        # next cell still runs
        try:
            rec["cells"][cell] = run_cell(
                cell, cards, 1 if cell == "nequip" else args.steps)
        except (Exception, SystemExit) as e:  # noqa: BLE001
            MISSES.append(f"{cell}: {type(e).__name__}: {e}")
            cs.progress(f"{cell} failed: {type(e).__name__}: {e}")
            rec["cells"][cell] = {"failed": f"{type(e).__name__}: {e}"}
            torch.cuda.empty_cache()
    if not args.no_check:
        try:
            rec["check"] = check(cells, cards)
        except (Exception, SystemExit) as e:  # noqa: BLE001
            MISSES.append(f"check: {type(e).__name__}: {e}")
            rec["check"] = {"failed": f"{type(e).__name__}: {e}"}
    cs.sync_all(cards)
    launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if launched:
        MISSES.append(f"kernels of the port launched: {launched}")
    rec["wall_s"] = time.perf_counter() - t0
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    rec["misses"] = MISSES
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if MISSES:
        print("chip_gnn_mesh: FAILED: " + "; ".join(MISSES), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
