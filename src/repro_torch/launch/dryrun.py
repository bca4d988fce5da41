"""The dry-run matrix, and the sharded serving stack run end to end.

Port of the reference package's `launch/dryrun.py`. Its matrix lowers and
compiles every (architecture x input-shape) cell on the production
meshes, (16, 16) = 256 chips and (2, 16, 16) = 512 chips, and records
memory, cost and collective analysis. The port has no compiler and no
SPMD partitioner, so `run_cell` counts instead: it runs the cell's global
step once on meta tensors (`launch.op_analysis`) and sizes it on the
abstract production mesh (`launch.mesh.make_production_mesh`, read as
256 and 512 H100s). Per card, the argument, output and donated bytes are
exact, from the cell's shardings; the FLOPs, HBM bytes, integer ops and
temporaries are the global count split evenly over the cards. There is
no collective term. With ``execute=True`` a cell whose counted peak one
card holds (with `HEADROOM`) also runs on the card at its global size,
from arguments drawn by a seeded `torch.Generator`: one warm-up step,
then the median of `EXEC_STEPS` steps timed with CUDA events (one step
where the one-card bound is over `EXEC_LONG_S`), and the
card's peak memory beside the counted peak. That run is the card's
counterpart of XLA's compile-time memory analysis, which the reference
has and the port cannot.

`run_serve` and `run_chaos` run the sharded serving stack: every engine
mode against the single-device engine, bit for bit, and the seeded chaos
schedules over several engine configurations. The reference runs them
on 8 virtual host devices forced by an XLA flag; here the mesh is built
explicitly: 8 logical shards on the chosen device, or 8 physical devices
where the chosen device is the card and 8 are visible.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--execute] [--out DIR]
    python -m repro_torch.launch.dryrun --serve [--quick] [--device cpu]
    python -m repro_torch.launch.dryrun --chaos [--quick] [--device cpu]

Records go to ``--out`` (default ``experiments/dryrun``) as
``{arch}__{shape}__{16-16|2-16-16}.json``; `launch.roofline` reads them.
``--execute`` and the serving stack run on the card unless ``--device``
names another device (``cpu``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

N_SHARDS = 8
# the card's allocator for the matrix's runs: GIN's ogb_products cell
# (73.9 GB counted) runs at 74.0 GB measured with expandable segments and
# fails by fragmentation without them (a 29.5 GiB request, 69.5 GiB held)
ALLOC_CONF = "expandable_segments:True"


def serving_devices(device=None) -> list:
    """The 8 shards' devices: 8 physical cards where the device is the
    card and 8 are visible, else 8 logical shards on ``device``."""
    from ..kernels._cuda import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= N_SHARDS:
        return [torch.device("cuda", i) for i in range(N_SHARDS)]
    return [dev] * N_SHARDS


def _instance_queries(g, V: int, W: int, seed: int):
    from ..core.generators import random_queries
    if V <= 16:  # the full (s, t, w) grid on the tiny instances
        s, t, wl = np.meshgrid(np.arange(V), np.arange(V), np.arange(W + 1),
                               indexing="ij")
        return tuple(a.ravel().astype(np.int32) for a in (s, t, wl))
    return random_queries(g, 512, seed=seed + 1)


def run_serve(quick: bool, device=None) -> None:
    """Every layout x dispatch x placement x (8, 2x4) mesh x compressed
    leg of `ShardedQueryEngine` against `DeviceQueryEngine` (queries and
    profiles, the profiles also against the per-level loop), then an
    epoch and a continuous-batching `WCSDServer(backend="sharded")`.
    Raises SystemExit on any mismatch."""
    from ..configs.wcsd_serve import smoke_serve_config
    from ..core.generators import erdos_renyi
    from ..core.query import DeviceQueryEngine, ShardedQueryEngine
    from ..core.serve import WCSDServer
    from ..core.wc_index import as_packed_index, build_wc_index
    from ..kernels._cuda import resolve_device
    from .mesh import make_serving_mesh

    dev = resolve_device(device)
    devices = serving_devices(dev)
    cfg = smoke_serve_config()
    instances = [(12, 3.5, 3, 5), (10, 2.5, 2, 11)] if quick else \
        [(12, 3.5, 3, 5), (10, 2.5, 2, 11), (60, 4.0, 4, 7),
         (120, 3.0, 5, 13)]
    t0 = time.time()
    for V, deg, W, seed in instances:
        g = erdos_renyi(V, deg, num_levels=W, seed=seed)
        idx = as_packed_index(build_wc_index(g))
        s, t, wl = _instance_queries(g, V, W, seed)
        for layout, dispatch in (("csr", "ragged"), ("csr", "bucket_pair"),
                                 ("padded", "ragged")):
            dev_eng = DeviceQueryEngine(idx, layout=layout,
                                        use_pallas=cfg.use_pallas,
                                        dispatch=dispatch, device=dev)
            exp = dev_eng.query(s, t, wl)
            exp_prof = np.stack([dev_eng.query(
                s, t, np.full(len(s), w, np.int32)) for w in range(W + 1)],
                axis=1)
            if not np.array_equal(dev_eng.query_profile(s, t), exp_prof):
                raise SystemExit(f"MISMATCH V={V} layout={layout} "
                                 "device profile vs per-level loop")
            # the compressed arena rides the csr-ragged legs only; hop
            # distances here stay inside bf16's exact range
            comp_legs = ((False, True) if (layout, dispatch)
                         == ("csr", "ragged") else (False,))
            for multi_pod in (False, True):
                mesh = make_serving_mesh(devices, multi_pod=multi_pod)
                for budget in (None, 1):  # replicated / sharded_labels
                    for compressed in comp_legs:
                        eng = ShardedQueryEngine(
                            idx, mesh=mesh, layout=layout,
                            use_pallas=cfg.use_pallas,
                            device_budget_bytes=budget, dispatch=dispatch,
                            compressed=compressed)
                        got = eng.query(s, t, wl)
                        tag = (f"V={V} layout={layout} "
                               f"dispatch={eng.dispatch} "
                               f"mesh={'2x4' if multi_pod else '8'} "
                               f"mode={eng.mode}"
                               + (" compressed" if eng.compressed else ""))
                        if not np.array_equal(got, exp):
                            raise SystemExit(
                                f"MISMATCH {tag}: "
                                f"{np.flatnonzero(got != exp)[:8]}")
                        if not np.array_equal(eng.query_profile(s, t),
                                              exp_prof):
                            raise SystemExit(f"MISMATCH profile {tag}")
                        print(f"OK {tag}: {len(s)} queries + profiles "
                              "bit-identical", flush=True)
        # async double-buffered server over the sharded backend
        mesh = make_serving_mesh(devices)
        srv = WCSDServer(idx, mesh=mesh, device=dev,
                         **{**cfg.server_kwargs(), "max_batch": 64})
        if not np.array_equal(srv.query_many(s, t, wl), exp):
            raise SystemExit(f"MISMATCH async server V={V}")
        if srv.results:
            raise SystemExit("read-once delivery left results behind")
        if not np.array_equal(srv.query_profile_many(s, t), exp_prof):
            raise SystemExit(f"MISMATCH async server profiles V={V}")
        if srv.profile_results:
            raise SystemExit("profile read-once left results behind")
        print(f"OK V={V} async server (+profiles): {srv.stats.batches} "
              f"batches, {srv.stats.memo_hits} memo hits", flush=True)
        # continuous batching: deadline and opportunistic flushes on, the
        # same submissions, the epoch server's answers
        srv_cb = WCSDServer(idx, mesh=mesh, device=dev,
                            **{**cfg.server_kwargs(), "max_batch": 64,
                               "max_wait_us": 200.0, "min_batch": 4})
        rids = [srv_cb.submit(int(a), int(b), int(c))
                for a, b, c in zip(s, t, wl)]
        srv_cb.flush()
        got = np.array([srv_cb.result(r) for r in rids], dtype=np.int32)
        if not np.array_equal(got, exp):
            raise SystemExit(f"MISMATCH continuous-batching server V={V}")
        lat = srv_cb.latency_summary()
        st = srv_cb.stats
        print(f"OK V={V} continuous batching: {st.batches} batches "
              f"({st.opportunistic_flushes} opportunistic, "
              f"{st.deadline_flushes} deadline), p50 {lat['p50_us']:.0f}us "
              f"p99 {lat['p99_us']:.0f}us", flush=True)
    print(f"serve dryrun PASS on {N_SHARDS} shards over "
          f"{len(set(devices))} {dev.type} device(s) "
          f"({time.time() - t0:.1f}s)", flush=True)


def chaos_legs(quick: bool, devices) -> list:
    """(tag, steps, seed, crash_step, server_kwargs overrides): the
    reference's legs, the sharded ones over an 8-shard mesh of
    ``devices``."""
    from .mesh import make_serving_mesh
    legs = [("csr-ragged-device", 200, 3, 100, {}),
            ("csr-ragged-sharded", 120 if quick else 200, 7, 60, {
                "backend": "sharded", "mesh": make_serving_mesh(devices)})]
    if not quick:
        legs += [("compressed-sharded", 200, 11, 110, {
                     "backend": "sharded",
                     "mesh": make_serving_mesh(devices),
                     "compressed": True}),
                 # a padded K9 primary, so the ladder has the plain padded
                 # oracle rung below it
                 ("padded-single", 200, 13, 90, {
                     "layout": "padded", "use_pallas": True})]
    if quick:
        legs[0] = ("csr-ragged-device", 120, 3, 60, {})
    return legs


def run_chaos(quick: bool, device=None) -> list:
    """The seeded chaos schedules (`checkpoint.fault.run_chaos_schedule`)
    over the legs of `chaos_legs`: every answer checked against the BFS
    oracle, the server back at its top rung at the end. Returns each
    leg's (tag, summary)."""
    from ..checkpoint.fault import run_chaos_schedule
    from ..kernels._cuda import resolve_device

    dev = resolve_device(device)
    devices = serving_devices(dev)
    t0 = time.time()
    out = []
    for tag, steps, seed, crash_step, overrides in chaos_legs(quick,
                                                              devices):
        with tempfile.TemporaryDirectory() as tmp:
            s = run_chaos_schedule(server_kwargs={**overrides,
                                                  "device": dev},
                                   steps=steps, seed=seed,
                                   crash_step=crash_step, workdir=tmp)
        if not (s["final_mode"] == "primary"
                and s["answered"] == s["submitted"]
                and s["injected"] > 0 and s["crashes"] == 1):
            raise SystemExit(f"chaos {tag} failed: {s}")
        print(f"OK chaos {tag}: {s['submitted']} answered, "
              f"{s['injected']} faults injected "
              f"({s['error_retries']}err/{s['timeout_retries']}to retries, "
              f"{s['demotions']} demotions, {s['promotions']} promotions), "
              f"{s['replayed_records']} WAL records replayed, "
              f"final mode {s['final_mode']}", flush=True)
        out.append((tag, s))
    print(f"chaos dryrun PASS on {N_SHARDS} shards over "
          f"{len(set(devices))} {dev.type} device(s) "
          f"({time.time() - t0:.1f}s)", flush=True)
    return out


# ------------------------------------------------------ the dry-run matrix
HEADROOM = 0.9     # a cell runs on a card whose memory its counted peak
                   # fits within this share of
EXEC_STEPS = 3     # timed steps of an executed cell, after one warm-up
EXEC_LONG_S = 10.0  # one timed step where the one-card bound is longer
                    # (NequIP's ogb_products: a 52 s bound)
EXEC_SEED = 0


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def describe(tree) -> dict:
    """{path: (shape, dtype)} of a tree's tensors."""
    from ..train.tree import flatten_with_paths
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in flatten_with_paths(tree).items()}


def sharded_bytes(tree, specs, mesh, keep=None) -> int:
    """Per-card bytes of a tree's tensors under ``specs`` (the same tree
    with `Spec` leaves, or a prefix of it: a `Spec` or None covers its
    whole subtree, None as replicated); ``keep`` picks leaves."""
    from ..train.tree import tree_leaves
    from .mesh import Spec, shard_shape
    if specs is None or isinstance(specs, Spec):
        return sum(t.element_size() * math.prod(shard_shape(t.shape, specs,
                                                            mesh))
                   for t in tree_leaves(tree) if keep is None or keep(t))
    if isinstance(tree, dict):
        return sum(sharded_bytes(tree[k], specs[k], mesh, keep)
                   for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(sharded_bytes(a, b, mesh, keep)
                   for a, b in zip(tree, specs, strict=True))
    raise TypeError(f"no spec for {type(tree).__name__}")


def cell_bytes(cell, multi_pod: bool) -> dict:
    """A cell's per-card argument, output and donated bytes on the
    production mesh (exact: from its shardings)."""
    from .mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    return {"argument_bytes": sharded_bytes(cell.args, cell.in_shardings,
                                            mesh),
            "output_bytes": sharded_bytes(cell.outs, cell.out_shardings,
                                          mesh),
            "alias_bytes": sum(sharded_bytes(cell.args[i],
                                             cell.in_shardings[i], mesh)
                               for i in cell.donate_argnums)}


def _storage_ids(tree) -> set:
    from ..train.tree import tree_leaves
    return {t.untyped_storage()._cdata for t in tree_leaves(tree)}


def count_cell(cell) -> tuple:
    """Count a cell's global step on its meta arguments
    (`op_analysis.count_step`) and check its result against ``cell.outs``.
    Returns (the counts, the result): the counts add ``argument_bytes``,
    ``new_output_bytes`` (outputs in storage of their own; decode writes
    its cache in place), ``peak_bytes`` (the counted peak live bytes, at
    least arguments plus new outputs) and ``count_s``."""
    from ..train.tree import tree_leaves
    from .op_analysis import count_step, storage_bytes
    t0 = time.perf_counter()
    outs, counts = count_step(cell.fn, cell.args)
    if describe(outs) != describe(cell.outs):
        raise RuntimeError(f"{cell.name}: the step returned "
                           f"{describe(outs)}, the cell says "
                           f"{describe(cell.outs)}")
    args_st = _storage_ids(cell.args)
    g_args = storage_bytes(cell.args)
    g_new = storage_bytes([t for t in tree_leaves(outs)
                           if t.untyped_storage()._cdata not in args_st])
    counts.update(argument_bytes=g_args, new_output_bytes=g_new,
                  peak_bytes=max(counts["peak_live_bytes"], g_args + g_new),
                  count_s=time.perf_counter() - t0)
    return counts, outs


def _family_args(cell):
    """The module whose `concrete_args` draws a cell's family's inputs."""
    from ..configs import gnn_common, lm_common, wcsd_serve, xdeepfm_arch
    return {"lm": lm_common, "gnn": gnn_common, "recsys": xdeepfm_arch,
            "wcsd": wcsd_serve}[cell.meta["family"]].concrete_args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def execute_cell(cell, counts: dict, device=None, check=None) -> dict:
    """Run a cell at its global size where its counted peak fits the
    device (the card unless ``device`` says otherwise; no fallback):
    arguments from its family's `concrete_args` with a generator seeded
    `EXEC_SEED`, one warm-up step (``check(args, result)`` sees its
    result, where given), then `EXEC_STEPS` steps (one where the
    one-card bound is over `EXEC_LONG_S`), each timed (CUDA events on the
    card, the host clock elsewhere), the card's peak memory from
    `torch.cuda.max_memory_allocated` after a reset, less what the card
    held before the arguments were drawn. Returns the record's
    ``executed``: ``step_ms`` (the median), ``steps_ms``, ``peak_bytes``,
    ``counted_peak_bytes``, the one-card bound and ``roofline_share``
    (bound over step; on the card only); or ``skipped`` with the reason;
    or ``error`` where the card ran out of memory."""
    from ..kernels._cuda import resolve_device
    from .roofline import CARD_BYTES, bound_s
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    capacity = (torch.cuda.get_device_properties(dev).total_memory
                if on_card else CARD_BYTES)
    rec = {"device": (torch.cuda.get_device_name(dev) if on_card
                      else dev.type),
           "counted_peak_bytes": counts["peak_bytes"]}
    bound, by = bound_s(counts["flops"], counts["int_ops"],
                        counts["moved_bytes"])
    rec.update(bound_ms=bound * 1e3, bound_by=by)
    if counts["peak_bytes"] > HEADROOM * capacity:
        rec["skipped"] = (f"counted peak {counts['peak_bytes'] / 1e9:.1f} "
                          f"GB > {HEADROOM:.0%} of {capacity / 1e9:.1f} GB")
        return rec
    try:
        return _execute(cell, dev, rec, bound, check)
    except torch.cuda.OutOfMemoryError as e:
        rec["error"] = f"out of memory: {str(e).splitlines()[0]}"
    torch.cuda.empty_cache()     # the failed step's tensors are gone now
    return rec


def _execute(cell, dev, rec: dict, bound: float, check) -> dict:
    on_card = dev.type == "cuda"
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(EXEC_SEED)
    args = _family_args(cell)(cell, gen)
    _sync(dev)
    out = cell.fn(*args)                                    # warm-up
    _sync(dev)
    if check is not None:
        check(args, out)
    del out
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for _ in range(1 if bound > EXEC_LONG_S else EXEC_STEPS):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = cell.fn(*args)
            e1.record()
            e1.synchronize()
            steps.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            out = cell.fn(*args)
            steps.append((time.perf_counter() - t0) * 1e3)
        del out
    step = statistics.median(steps)
    rec.update(step_ms=step, steps_ms=steps,
               peak_bytes=(torch.cuda.max_memory_allocated(dev) - base
                           if on_card else None),
               roofline_share=bound * 1e3 / step if on_card else None)
    del args
    if on_card:
        torch.cuda.empty_cache()
    return rec


def cell_record(arch: str, shape: str, cell, multi_pod: bool, counts: dict,
                outs, executed=None) -> dict:
    """The record of one (cell, mesh): the reference's keys where they
    mean something here (``arch``, ``shape``, ``kind``, ``mesh``,
    ``chips``, ``meta``, ``memory``, ``cost``), ``count_s`` for its
    ``lower_s`` / ``compile_s``, the global ``count`` and ``executed``."""
    from .mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    per = cell_bytes(cell, multi_pod)
    args_st = _storage_ids(cell.args)
    inplace = sharded_bytes(
        outs, cell.out_shardings, mesh,
        keep=lambda t: t.untyped_storage()._cdata in args_st)
    temp = max(0, counts["peak_bytes"] - counts["argument_bytes"]
               - counts["new_output_bytes"]) // chips
    rec = {"arch": arch, "shape": shape, "kind": cell.kind,
           "mesh": mesh_name(multi_pod), "chips": chips,
           "meta": dict(cell.meta),
           "memory": dict(per, temp_bytes=temp, inplace_bytes=inplace,
                          peak_bytes=per["argument_bytes"]
                          + per["output_bytes"] - inplace + temp),
           "cost": {"flops": counts["flops"] / chips,
                    "bytes_accessed": counts["hbm_bytes"] / chips,
                    "moved_bytes": counts["moved_bytes"] / chips,
                    "int_ops": counts["int_ops"] / chips},
           "per_card": {"exact": ["argument_bytes", "output_bytes",
                                  "alias_bytes", "inplace_bytes"],
                        "even_split": ["flops", "bytes_accessed",
                                       "moved_bytes", "int_ops",
                                       "temp_bytes"]},
           "count": {k: counts[k] for k in (
               "flops", "hbm_bytes", "moved_bytes", "int_ops", "kernels",
               "ops", "peak_bytes", "argument_bytes", "new_output_bytes")},
           "count_s": counts["count_s"]}
    if executed is not None:
        rec["executed"] = executed
    return rec


def record_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    """The reference's file name: ``{arch}__{shape}__{16-16|2-16-16}``."""
    return os.path.join(out_dir, f"{arch}__{shape}__"
                                 f"{mesh.replace('x', '-')}.json")


def _write(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"]),
              "w") as f:
        json.dump(rec, f, indent=1)


def run_cells(arch: str, shape: str, meshes, out_dir: str,
              execute: bool = False, device=None) -> list:
    """Count one cell once (the count does not depend on the mesh), with
    ``execute`` run it on the card where one holds it, and write its
    record on each production mesh of ``meshes`` (False: 16 x 16, True:
    2 x 16 x 16). Returns the records."""
    from ..configs import get_arch
    mod = get_arch(arch)
    cells = [mod.make_cell(shape, multi_pod=mp) for mp in meshes]
    counts, outs = count_cell(cells[0])
    ex = execute_cell(cells[0], counts, device) if execute else None
    recs = [cell_record(arch, shape, c, mp, counts, outs, ex)
            for c, mp in zip(cells, meshes)]
    for rec in recs:
        _write(rec, out_dir)
    return recs


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             execute: bool = False, device=None) -> dict:
    """`run_cells` on one mesh: the reference's `run_cell`."""
    return run_cells(arch, shape, [multi_pod], out_dir, execute, device)[0]


def _summary(rec: dict) -> str:
    m, ex = rec["memory"], rec.get("executed") or {}
    line = (f"{rec['arch']} {rec['shape']} {rec['mesh']}: count "
            f"{rec['count_s']:.1f}s, peak/card {m['peak_bytes'] / 2**30:.2f}"
            f" GiB, flops/card {rec['cost']['flops']:.3e}")
    if "step_ms" in ex:
        peak = ("not measured" if ex["peak_bytes"] is None
                else f"{ex['peak_bytes'] / 1e9:.2f} GB")
        line += (f"; {ex['device']}: {ex['step_ms']:.3f} ms, peak {peak} "
                 f"(counted {ex['counted_peak_bytes'] / 1e9:.2f} GB)")
        if ex["roofline_share"] is not None:
            line += f", roofline share {ex['roofline_share']:.3f}"
    elif "skipped" in ex or "error" in ex:
        line += f"; not run: {ex.get('skipped') or ex['error']}"
    return line


def run_all(meshes, out_dir: str, execute: bool = False, device=None,
            skip_existing: bool = False) -> list:
    """Every cell of the matrix (the 40 of `configs.all_cells` and the
    wcsd-serve cells), counted once (the count does not depend on the
    mesh) and recorded on each mesh of ``meshes``. A cell that fails is
    reported and the rest go on; returns the failures."""
    from ..configs import ARCHS, EXTRA_ARCHS, get_arch
    jobs = [(a, s) for a in list(ARCHS) + list(EXTRA_ARCHS)
            for s in get_arch(a).SHAPES]
    failures = []
    for i, (arch, shape) in enumerate(jobs):
        if skip_existing and all(os.path.exists(record_path(
                out_dir, arch, shape, mesh_name(mp))) for mp in meshes):
            print(f"[{i + 1}/{len(jobs)}] skip {arch} {shape}", flush=True)
            continue
        try:
            for rec in run_cells(arch, shape, meshes, out_dir, execute,
                                 device):
                print(f"[{i + 1}/{len(jobs)}] {_summary(rec)}", flush=True)
        except Exception:   # one cell's failure must not end the matrix
            traceback.print_exc()
            failures.append((arch, shape))
            print(f"[{i + 1}/{len(jobs)}] {arch} {shape} FAILED",
                  flush=True)
    print(f"done: {len(jobs) - len(failures)}/{len(jobs)} OK", flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--execute", action="store_true",
                    help="also run each cell one card holds, on the card")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    if args.serve or args.chaos:
        if args.serve:
            run_serve(quick=args.quick, device=args.device)
        if args.chaos:
            run_chaos(quick=args.quick, device=args.device)
        return
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        failures = run_all(meshes, args.out, execute=args.execute,
                           device=args.device,
                           skip_existing=args.skip_existing)
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        return
    if not (args.arch and args.shape):
        ap.error("pass --arch and --shape, --all, --serve or --chaos")
    for rec in run_cells(args.arch, args.shape, meshes, args.out,
                         args.execute, args.device):
        print(_summary(rec), flush=True)


if __name__ == "__main__":
    main()
