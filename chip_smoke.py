#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Builds the twelve CUDA kernels from the four sources in
`src/repro_torch/csrc/` (one `nvcc` per source, started together), then
drives seventeen paths of the port on the card, each with the launch counts
reset just before it and read just after it:

1. the main path: `scale_free(2^17, m=4, num_levels=5, seed=0)` -> the
   rank-batched device builder (K3, K4) -> `WCSDServer` serving 2^20
   random queries and 2^16 profile queries (K1, K2), once in epoch
   flushes and once under continuous batching;
2. compressed serving: `scale_free(2^15, ...)`, the largest V of the
   family whose hub deltas all fit int16, served through
   `WCSDServer(compressed=True)` (K5, K6) in epoch flushes;
3. the fallback ladder on the V = 2^15 store: a compressed server under
   the flush watchdog whose engines a `FaultyEngine` makes raise and hang
   on a fixed schedule, walked down every rung (K5/K6, K1/K2, K7/K8, the
   plain padded oracle) and promoted back to the top;
4. bucket-pair serving: the V = 2^17 index served through
   `WCSDServer(dispatch="bucket_pair")` in epoch flushes (one K7 launch
   per scalar flush, one K8 launch per profile flush);
5. padded serving: the V = 2^17 index from the padded ``[V, L]`` store,
   `WCSDServer(layout="padded", use_pallas=True)` (K9; plain profiles),
   in epoch flushes;
6. single-root constrained BFS at V = 2^17 through `ops.frontier_relax`
   (K10), round by round, from three roots;
7. the dynamic index, `scale_free(2^12, m=4, num_levels=5, seed=0)` (cut
   from 2^17: one update re-runs the sequential Algorithm 3 on the host
   for every root of the edge's connected component, here the whole
   graph, ~x3 a doubling of V; cut from 2^13 to keep the whole run under
   800 s of its 1,200 s as the LM phase joined): a card build (K3, K4)
   served
   statically, then a dynamic,
   WAL-backed `WCSDServer(graph=g, wal_path=...)` through two update
   batches (1 insert at the middle level + 1 delete each), each followed
   by 2^18 queries and 2^14 profiles over the delta-extended arena (one
   K1 / K2 launch a flush) held against a card build from scratch of the
   mutated graph and the host BFS; a warm start from the v0 WCX
   checkpoint replaying the WAL; `compact()` on the card, byte-identical
   to the fresh build; a WCX round trip of the compacted base; and the
   seeded chaos schedule (200 steps, a crash at step 100) on the card;
8. xDeepFM serving at full width (`configs.xdeepfm_arch.get_config()`:
   8,031,232 embedding rows, CIN 200-200-200, MLP 400-400, random
   weights from seed 0): 256 `serve_p99` batches of 512 and 4
   `serve_bulk` batches of 262,144 from `CTRStream`, host to host, and
   one `retrieval_cand` query against 1,000,000 candidates; one K11
   launch per CIN layer of every forward;
9. the sharded serving engine (run right after the ladder): 8 logical
   shards on the card, as an 8-shard and a 2x4 (pod, data) mesh. Every
   placement of every layout (ragged, bucket-pair, padded; replicated
   and row-sharded labels) on the V = 2^17 index, and the compressed
   arena on the V = 2^15 store, over a prefix of its stream, equal to
   the device server, every call launching its kernel once per shard
   (K1/K2, K5/K6, K7/K8, K9; the padded profiles are the plain join);
   the row-sharded flush's host plan, tile gather and worklist lengths,
   and shard 0's K1 / K2 on the engine's own launch inputs over its
   gathered tiles against their plain versions; epoch servers
   (device, replicated, row-sharded, row-sharded, replicated, device)
   over 2^18 queries + 2^14 profiles with K1 = 8 x scalar flushes and
   K2 = 8 x profile flushes; and `launch.dryrun`'s `run_serve` and
   `run_chaos` at full size on the card;
10. xDeepFM training at full width (`get_config()`, train_batch B =
   65,536, AdamW lr 1e-3 from `configs.xdeepfm_arch.TRAIN_OPT`): a
   `Trainer` with a `CheckpointManager` over 8 steps from `CTRStream`
   (per step: K11 nine times, the wide kernel three times forward and
   for dx1 of the two 200-wide layers, the narrow kernel for the three
   dx0 and the first layer's dx1, one call each; and K12 three times),
   then a `FaultTolerantRunner` over the same steps with a failure at
   step 5, ending bit for bit on the Trainer's parameters and moments;
   one step with ``accum_steps=4`` and one with ``compress_grads=True``
   held against the first; a whole step's gradient at 2,048 rows
   against the plain path on the card; one step's device time by
   kernel from `torch.profiler` (a warm-up step, then the traced one);
11. the port's examples (`examples/quickstart_torch.py`,
   `examples/serve_wcsd_torch.py`, `examples/wcsd_features_gnn_torch.py`,
   `examples/train_lm_torch.py`) at their default sizes on the card,
   their own asserts included (the LM example launches no kernel);
12. the GNN family (run right after the single-root BFS), on the main
   path's V = 2^17 graph and index: the feature stage,
   `data.graphs.distance_encoding` of all 131,072 vertices against the 8
   highest-degree vertices at levels 0-4 (5,242,880 queries through one
   ragged `DeviceQueryEngine`, one K1 launch a flush of 2^18), every
   flush held against the engine's plain path on the card and every
   vertex (64 sampled ones first) against the host BFS, clipped; then
   GIN (5 x 64), PNA (4 x 75) and GatedGCN (16 x 70) at `get_config()`
   width, 4 AdamW steps at each of the padded full_graph_sm (N 2,709,
   E 21,504), molecule (N 3,841, E 32,768, 128 graphs) and minibatch_lg
   (a `NeighborSampler` block of 1,024 seeds, fanouts 15-10, over the
   graph, `pad_block`ed to N 184,832, E 337,920, bf16) shapes, each loss
   finite and the last step re-run bit-identical, one fp32 full_graph_sm
   forward per arch against the CPU (TF32 off, the real nodes within
   1e-4 of max |ref|, the sink node within 2e-3); NequIP (5 layers, 32 channels, l <= 2) on
   molecule with forces (a second derivative through the segment
   backend) and on minibatch_lg energy-only in 8 edge chunks, 4 steps
   each, energies invariant under a rotation within 1e-4, the last step
   re-run bit-identical. No kernel of the port runs in the training
   (the reference's message passing is not a Pallas kernel);
13. the LM family, llama3-8b (32 x 4,096, GQA 32/8) and
   qwen2-moe-a2.7b (24 x 2,048, 60 experts padded to 64, top-4, 4
   shared, 16 dispatch shards) at `get_config()` width and depth,
   random weights from seed 0 on the card's generator, served in bf16
   with the router and shared output gate in float32: first the float32
   checks at 2 layers of full width (a 128-token forward on the card
   against the same forward on the CPU, TF32 off; 16 decode steps after
   a 48-token prompt against the card's no-cache forward, each held
   per position; bf16 forwards with cuBLAS's reduced-precision bf16
   reductions on and off against the float32 one, printed); then
   prefill_32k cut to one row of 32,768 `TokenStream` tokens (after a
   4,096-token warm-up prefill re-run bit for bit; every logit finite;
   qwen's dropped-token share) and decode_32k cut to 8 rows (qwen: 4)
   of a 4,096-token (2,048) prompt in a 32,768-long cache and 32 greedy
   steps over the whole cache, each timed, one traced, and each row's
   no-cache bf16 forward over the same tokens (greedy share, printed).
   No kernel of the port runs (the reference's attention and experts
   are jnp ops outside any Pallas kernel);
15. the mesh-only parallel code (run after the LM family), 4 logical
   shards of the card as a ("data", "model") 1 x 4 mesh: llama3-8b's
   long_500k at full width cut to 4 layers, one row, its 524,288-long
   bf16 cache split into 4 sequence blocks filled from a seeded
   generator, 4 greedy steps at S - 4 .. S - 1 through `decode_step`
   over the sharded cache against the unsharded `decode_step` on a copy
   of the same cache (greedy tokens equal; ms a step against the bytes
   bound, peak, one step's idle share), and again at 2 layers of
   float32 masters (within 1e-4 of max |ref|); qwen2-moe-a2.7b at full
   width, 2 float32 layers, 8 rows decoding through
   `moe_ffn_replicated_ep` (16 experts a shard) against the same steps
   on the CPU; `gpipe_forward` (4 stages, 8 microbatches of [512,
   4096], float32) against the stages applied in turn; the served path
   over parameters stored by their specs: llama3-8b, 2 float32 layers,
   a 2,048-token prompt through `prefill_step` into a 2,112-long
   sequence-sharded cache, then 16 greedy `decode_step`s, against the
   unsharded prefill and decode on the same weights (tokens equal,
   logits within 1e-4 of max |ref|), and dbrx-132b, 2 bf16 layers, the
   same prompt (its next token the argmax of the forward's last
   position, the peak within the cache and the reckoned transients).
   No kernel of the port runs (the reference's three functions are jnp
   ops);
16. training over a mesh (after path 15), 4 logical shards of the card:
   llama3-8b at full width cut to 2 layers of float32 masters (1.49 B),
   every leaf and its AdamW moments stored by their specs over
   ("data", "model") 4 x 1, drawn shard by shard (equal byte for byte
   to `shard_params` of the whole draw), three `make_train_step(mesh=)`
   steps on 4 rows of 1,024 tokens (one a shard), held against the
   unsharded steps over the same row blocks (losses, the first moment,
   the parameters; within 1e-5) and beside the unsharded steps over the
   whole batch, each shard's storage its blocks' bytes; dbrx-132b at
   full width cut to 2 float32 layers over 1 x 4, the per-shard draw
   against `shard_params` byte for byte, then 4 greedy decode steps at
   8 rows over a seeded 32,768-long cache with the leaves stored by
   their specs against the whole leaves (within 1e-5, greedy equal),
   the phase's peak recorded; qwen2-moe-a2.7b's smoke config over 2 x 2
   (float32, the MoE layer one recompute over the shards, counted), three
   steps against the unsharded steps over the same row blocks with the
   experts routed as a data shard routes them (within 1e-5); a sharded
   train state's checkpoint
   (llama3-8b's smoke config over 2 x 2, one AdamW step) restored onto
   2 x 1, the restarted step equal bit for bit to the same step from
   the state stored there in memory. No kernel of the port runs;
17. the graph family over a mesh (after path 16), 4 logical shards of
   the card as ("data",) 4: GIN, PNA and GatedGCN at full width and
   depth, sized by `shape_config(cfg, "ogb_products")`, the edges and
   the node rows and labels split over "data" by the cell's specs, the
   parameters replicated: on a uniform random graph of 2^17 nodes and
   2^21 edges (`BIG_GRAPH` lowered to 2^16: blocks of 4 layers
   recompute, each shard's edges run in 4 chunks), one float32 step
   (PNA: float64, its float32 gradient is noise at this width) sharded
   (twice, bit for bit) against the unsharded step (the loss within
   1e-5 relative, every leaf of the clipped gradient within 1e-4 of its
   max |ref|); on 2^19 nodes and 2^23 edges (past `BIG_GRAPH`, 4 chunks
   of 2^19 a shard), one bf16 step each, timed, the loss gap reported;
   NequIP on molecule with forces at the same bars. No kernel of the
   port runs;
14. the dry-run matrix (run last, `launch.dryrun`): all 84 cells (the
   40 arch x shape cells and wcsd-serve's 2, on the 16 x 16 and 2 x 16 x
   16 production meshes) built with their per-card argument and output
   bytes; llama3-8b and qwen2-moe-a2.7b decode_32k, gin-tu
   full_graph_sm, nequip molecule, xdeepfm train_batch and wcsd-serve
   serve_1m counted on meta tensors at full width; wcsd-serve serve_1m
   (2^20 queries, K9) and profile_1m (2^17 staircases, the plain join)
   and xdeepfm serve_p99 and retrieval_cand (K11) run on the card at
   their global sizes from seeded arguments, each timed beside its
   counted peak and one-card roofline bound; 4,096 of serve_1m's
   answers held against K9's plain version, exactly.

Then every kernel is held against its plain PyTorch version on inputs
captured from its path (exact int32 equality; K3 at the build's heaviest
pruning call, K4 at round 1 of the middle root batch and of root batch
0, both again with every row's pads moved mid-row, K4 also with pad ids
V, and both on the smallest inputs of the fault C1; K7 and K8 on the
grouped flush, every sub-batch, and unsorted rows; K1, K2, K5, K6 and
K9 also with every tile's or row's cells shuffled, which their merge check
refuses (the share of items or queries that pass it is recorded; K9's
record also times the gather before it); K11, 3xTF32 on the tensor cores
summed in fp32 in another order, within 1e-4 of each layer's max |ref|
on the model's own activations and at the reference test's tolerance on
unit-normal inputs, and 8 rows of one batch against the plain forward
in float64 on the CPU, and bit-identical across two launches; K12 and
K11's forward and backward calls (wide and narrow kernel) on one train
step's own inputs, within 1e-4 of each output's max |ref| and
bit-identical across two launches, each one's einsum on the whole batch
too) and timed with CUDA events; every
served flush (every
sub-batch, for bucket-pair) is checked against the plain path; every
served logit is finite and the retrieval top 100 equals float64's on
the host; the compressed answers equal an uncompressed
server's on the same index, the ladder's the compressed server's, and
the bucket-pair and padded answers the ragged server's over the whole
stream; every BFS round equals the plain version and the final levels the
host BFS at every level; 64 pairs are checked against the host BFS at
every level, and a 2,000-vertex build on the card against the same build
on the CPU, byte for byte. K1 and K2 are also held against their plain
versions on the first flushes over the dynamic index's delta-extended
arena and over its static arena, timed, with the share of meeting items
that pass the merge check (held at 1.0 over the items that touch a
delta tile). The V = 2^17 store's compressed arena is built
too: its overflowed tiles are counted and, where there are any, an engine
asked for ``compressed=True`` must serve it uncompressed and say so.

Prints one JSON object per phase, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, if there is no CUDA device, a kernel does not build
or launch, or any check fails.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores (same)
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM dense TF32 on the tensor cores (same)
# int32 ALU ops/s: 132 SMs x 64 INT32 lanes x 1.98 GHz boost. The data
# sheet's 67 TFLOP/s fp32 is the same clock on 128 FP32 lanes x 2 (FMA).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DEVICE = "cuda"
LOG2_V = 17          # build: scale_free(2^17, m=4, num_levels=5, seed=0)
BATCH = 32           # roots per build batch
LOG2_QUERIES = 20    # served scalar queries
LOG2_PROFILES = 16   # served profile queries
LOG2_V_COMPRESSED = 15  # compressed serving: every hub delta fits int16
BF16_EXACT = 256     # distances bf16 holds exactly
MAX_BATCH = 4096     # server flush size
CHECK_V = 2000       # vertices of the card-vs-CPU build identity check
BFS_PAIRS = 64       # served pairs checked against the host BFS
BFS_ROOTS = 3        # single-root relaxation runs (K10)
LADDER_PER = 512     # scalar requests per ladder flush (and a quarter as
                     # many profiles)
LADDER_TIMEOUT_MS = 2000.0  # the ladder server's flush deadline
DEV_INF = 1 << 29
INF_DIST = 1 << 30


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str):
    """Mean device milliseconds per call of the CUDA kernels whose name
    holds ``kernel`` among those ``fn`` launches, from a `torch.profiler`
    trace of ``iters`` calls after one warm-up call: the kernel alone,
    where `cuda_ms` also counts the wrapper's host time whenever the host
    is the slower side. None where the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if kernel in e.key.split("(")[0]:
            t = getattr(e, "device_time_total", None)
            us += e.cuda_time_total if t is None else t
    return us / iters / 1e3 if us else None


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def hub_meets(hs, ht, chunk_cells: int = 1 << 26) -> int:
    """Cell pairs of real hubs (>= 0) that meet, summed over the row pairs
    ``hs[i]`` x ``ht[i]`` ([n, Ws] and [n, Wt] on the card)."""
    import torch
    n, Ws = hs.shape
    step = max(1, chunk_cells // max(Ws * ht.shape[1], 1))
    total = torch.zeros((), dtype=torch.int64, device=hs.device)
    for a in range(0, n, step):
        x, y = hs[a:a + step], ht[a:a + step]
        total += ((x[:, :, None] == y[:, None, :])
                  & (x >= 0)[:, :, None]).sum()
    return int(total.item())


def join_ops(cells: int, meets: int, profile: bool) -> int:
    """The least int32 operations of a join over hub-sorted rows: a merge
    join takes one hub compare per cell of either side (``cells``), then
    per meet an add and a min, and for a profile also the pair level's
    min (the bin). The kernels compare every cell pair instead; that is
    their cost, not the function's."""
    return cells + (3 if profile else 2) * meets


# ----------------------------------------------------------------- phases
def toolchain() -> dict:
    import torch
    from repro_torch.kernels import _cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    try:
        import triton  # noqa: F401  (only whether it imports is reported)
        has_triton = True
    except ImportError:
        has_triton = False
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    return {"phase": "toolchain", "nvidia_smi": smi[0] if smi else None,
            "torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "nvcc": nvcc[-1] if nvcc else None, "triton": has_triton,
            "device": torch.cuda.get_device_name(0),
            "kernel_build_s": build_s}


class Capture:
    """Wraps the build's two round wrappers to keep (clones of) the inputs
    of one call each, and to bracket every call with CUDA events (the
    step's device time, launch overhead included). K3 keeps the pruning
    call that scans the most label entries in the whole build when every
    row is read to its end (active (root, vertex) pairs times their row
    ends: one extra host sync per round), with the row ends the builder
    passed; K4 keeps round 1 of the middle root batch and round 1 of root
    batch 0 (the hub roots, whose frontier is dense). For K3's build-total
    bound it sums, per call on the card, a floor of what the call must
    move: F read and emit written once, a whole row for every vertex where
    a root emits (its feasible entries must all be seen) and one entry
    for every other active vertex with a row. The wrapped call itself is
    the original, so the launch counts are unchanged."""

    def __init__(self, ops, target_batch: int):
        self.ops = ops
        self.target = target_batch
        self.orig = (ops.wc_prune_emit, ops.wc_relax_batched)
        self.k3 = self.k4 = self.k4_dense = None
        self.k3_scanned = -1
        self._T = self._lens = None
        self.events = {"wc_prune_emit": [], "wc_relax_batched": []}
        self._rr = None
        self._b4 = -1
        self._k4_calls = 0
        self.floor_cells = 0            # sum of B * V over pruning calls
        self.floor_rows = None          # entries, a device scalar

    def __enter__(self):
        prune, relax = self.orig

        def wc_prune_emit(F, T, hub, dist, wlev, d, *, do_prune=True,
                          row_end=None):
            if do_prune:
                if T is not self._T:      # a new root batch: rows have grown
                    self._T = T
                    self._lens = row_end if row_end is not None \
                        else (hub >= 0).sum(1)
                n = int(((F >= 0).sum(0) * self._lens).sum().item())
                if n > self.k3_scanned:
                    self.k3 = None                  # free the old clones
                    self.k3 = tuple(x.clone() for x in (F, T, hub, dist,
                                                        wlev)) + (
                        int(d), None if row_end is None else row_end.clone())
                    self.k3_scanned = n
            with self._timed("wc_prune_emit"):
                out = prune(F, T, hub, dist, wlev, d, do_prune=do_prune,
                            row_end=row_end)
            if do_prune:
                self._floor(F, out)
            return out

        def wc_relax_batched(emit_w, nbr, lvl, rank, rr, R, *, row_end=None):
            if rr is not self._rr:
                self._rr, self._b4, self._k4_calls = rr, self._b4 + 1, 0
            self._k4_calls += 1
            if self._b4 in (0, self.target) and self._k4_calls <= 2:
                x = (emit_w.clone(), nbr, lvl, rank, rr.clone(), R.clone(),
                     row_end)
                if self._b4 == self.target:
                    self.k4 = x
                if self._b4 == 0:
                    self.k4_dense = x
            with self._timed("wc_relax_batched"):
                return relax(emit_w, nbr, lvl, rank, rr, R, row_end=row_end)

        self.ops.wc_prune_emit = wc_prune_emit
        self.ops.wc_relax_batched = wc_relax_batched
        return self

    def _floor(self, F, emit):
        import torch
        L = self._lens
        rows = torch.where((emit >= 0).any(0), L, torch.where(
            (F >= 0).any(0), L.clamp(max=1), 0)).sum()
        self.floor_rows = rows if self.floor_rows is None \
            else self.floor_rows + rows
        self.floor_cells += F.numel()

    def floor_bound_s(self) -> float:
        """K3's build-total bound: the floor summed over every call."""
        rows = 0 if self.floor_rows is None else int(self.floor_rows.item())
        return bound_ms(8 * self.floor_cells + 12 * rows, 0)[0] / 1e3

    def __exit__(self, *exc):
        self.ops.wc_prune_emit, self.ops.wc_relax_batched = self.orig
        self._rr = self._T = self._lens = None

    @contextlib.contextmanager
    def _timed(self, name):
        import torch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        self.events[name].append(ev)

    def step_seconds(self) -> dict:
        """Summed device time of each wrapped step (call after a sync)."""
        return {k: sum(a.elapsed_time(b) for a, b in evs) / 1e3
                for k, evs in self.events.items()}


def record_flushes(engine, log: list) -> None:
    """Log every flush the server dispatches: (kind, s, t, wl, handle)."""
    qa, pa = engine.query_async, engine.query_profile_async

    def query_async(s, t, wl):
        h = qa(s, t, wl)
        log.append(("query", s.copy(), t.copy(), wl.copy(), h))
        return h

    def query_profile_async(s, t):
        h = pa(s, t)
        log.append(("profile", s.copy(), t.copy(), None, h))
        return h

    engine.query_async = query_async
    engine.query_profile_async = query_profile_async


def serve_epoch(idx, qs, ps, max_batch, log, device, **engine_kw):
    from repro_torch.core.serve import WCSDServer
    srv = WCSDServer(idx, max_batch=max_batch, device=device, **engine_kw)
    record_flushes(srv.engine, log)
    t0 = time.perf_counter()
    out = srv.query_many(*qs)
    prof = srv.query_profile_many(*ps)
    wall = time.perf_counter() - t0
    return srv, out, prof, wall


def serve_continuous(idx, qs, ps, max_batch, log, device):
    from repro_torch.core.serve import WCSDServer
    srv = WCSDServer(idx, max_batch=max_batch, max_wait_us=200.0,
                     min_batch=max_batch // 4, device=device)
    record_flushes(srv.engine, log)
    s, t, wl = qs
    every = max(1, len(s) // max(len(ps[0]), 1))
    rids, prids = [], []
    t0 = time.perf_counter()
    for i in range(len(s)):
        rids.append(srv.submit(int(s[i]), int(t[i]), int(wl[i])))
        if i % every == 0 and len(prids) < len(ps[0]):
            j = len(prids)
            prids.append(srv.submit_profile(int(ps[0][j]), int(ps[1][j])))
        if i % 256 == 0:
            srv.poll()
    srv.flush()
    out = np.array([srv.result(r) for r in rids], dtype=np.int32)
    prof = np.stack([srv.profile_result(r) for r in prids])
    wall = time.perf_counter() - t0
    return srv, out, prof, wall


def flush_inputs(engine, rec):
    """The worklist of one recorded flush, on the card."""
    import torch
    from repro_torch.core.query import emit_ragged_worklist, \
        ragged_worklist_len, TRASH_LEVEL
    kind, s, t, wl, _ = rec
    stq = engine._stage_ragged(s, t, wl)
    n_len = ragged_worklist_len(engine._tile_cnt_np, stq[0], stq[1])
    st = torch.from_numpy(stq).to(engine.device)
    hub, dist, wlev, lo, hi, base, cnt = engine._arena
    qidx, stile, ttile, first = emit_ragged_worklist(
        base, cnt, st[0], st[1], worklist_len=n_len)
    wq = None
    if kind == "query":
        wq = torch.cat([st[2], torch.full((1,), TRASH_LEVEL,
                                          dtype=torch.int32, device=st.device)])
    return (hub, dist, wlev, lo, hi, qidx, stile, ttile, wq,
            int(st.shape[1]) + 1)


def plain_flush(engine, rec) -> np.ndarray:
    """The plain PyTorch path for one recorded ragged flush (compressed or
    not), chunked, on the card."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wcsd_query as kwq
    hub, dist, wlev, lo, hi, qidx, stile, ttile, wq, rows = \
        flush_inputs(engine, rec)
    n = len(rec[1])
    if engine.compressed:
        arena = (hub, dist, wlev, lo)
        query = kwq.wcsd_query_ragged_compressed_plain
        profile = kwq.wcsd_profile_ragged_compressed_plain
    else:
        arena = (hub, dist, wlev)
        query = kwq.wcsd_query_ragged_plain
        profile = kwq.wcsd_profile_ragged_plain
    if rec[0] == "query":
        best = query(*arena, qidx, stile, ttile, wq)
        return kops._to_inf_dist(best)[:n].cpu().numpy()
    b = profile(*arena, qidx, stile, ttile, rows, engine.num_levels)
    return kops._staircase(b)[:n].cpu().numpy()


def sub_batches(engine, rec):
    """The planned sub-batches of one recorded bucket-pair flush, staged
    on the card as the engine stages them: (sub, [3 or 2, n] staging,
    the six bucket tiles)."""
    import torch
    from repro_torch.core.query import plan_query_batch, stage_sub_batch
    kind, s, t, wl, _ = rec
    out = []
    for sub in plan_query_batch(engine._bucket_of, s, t,
                                num_buckets=engine.num_buckets):
        stq = torch.from_numpy(stage_sub_batch(
            engine._slot_of, sub.positions, s, t, wl)).to(engine.device)
        out.append((sub, stq, engine._tiles[sub.bucket_s]
                    + engine._tiles[sub.bucket_t]))
    return out


def plain_sub_batch(engine, kind, stq, tiles):
    """The plain PyTorch path for one bucket-pair sub-batch, on the card."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wcsd_segmented as kseg
    if kind == "query":
        return kops._to_inf_dist(kseg.wcsd_query_segmented_plain(
            *tiles, stq[0], stq[1], stq[2])).cpu().numpy()
    return kops._staircase(kseg.wcsd_profile_segmented_plain(
        *tiles, stq[0], stq[1], engine.num_levels)).cpu().numpy()


_BFS_GRAPH = None


def _bfs_init(g) -> None:
    global _BFS_GRAPH
    _BFS_GRAPH = g


def _bfs_row(pair):
    from repro_torch.core.ref import wcsd_bfs
    g = _BFS_GRAPH
    return [wcsd_bfs(g, pair[0], pair[1], w) for w in range(g.num_levels + 1)]


# ------------------------------------------------------- kernel phases
RAGGED_KERNELS = {  # (profile, compressed) -> name, TPU kernel it replaces
    (False, False): ("wcsd_query_ragged",
                     "src/repro/kernels/wcsd_query.py:283"),
    (True, False): ("wcsd_profile_ragged",
                    "src/repro/kernels/wcsd_query.py:371"),
    (False, True): ("wcsd_query_ragged_compressed",
                    "src/repro/kernels/wcsd_query.py:456"),
    (True, True): ("wcsd_profile_ragged_compressed",
                   "src/repro/kernels/wcsd_query.py:529"),
}


def mergeable_rows(hub, pad_inert):
    """[n] bool: the merge kernels' check of each row of ``hub`` [n, W]
    (real cells non-decreasing in hub, pads only after them, every pad
    inert where ``pad_inert`` says so), computed here from the inputs,
    not read from the kernel."""
    real = hub >= 0
    prefix = ~(real[:, 1:] & ~real[:, :-1]).any(1)
    rising = ~(real[:, 1:] & real[:, :-1]
               & (hub[:, 1:] < hub[:, :-1])).any(1)
    return prefix & rising & ~(~real & ~pad_inert).any(1)


def mergeable_at(hub, dist, wlev, tiles, w):
    """[n] bool: K1's (and K5's) merge check of tile ``tiles[i]`` at level
    ``w[i]``: `mergeable_rows`' order, and every pad of the tile inert at
    that level (its distance, masked where its wlev < w, is >= DEV_INF),
    computed here from the inputs. Compressed tiles are taken as they are
    stored: a hub delta's sign is the pad flag and the deltas' order the
    hubs' order; a float distance decodes below DEV_INF exactly where it
    is below DEV_INF."""
    import torch
    ok = mergeable_rows(hub, hub == hub)
    d = dist.float() if (isinstance(dist, torch.Tensor)
                         and dist.is_floating_point()) else dist
    live = (hub < 0) & (d < DEV_INF)         # pads a low level makes count
    return ok[tiles] & ~(live[tiles] & (wlev[tiles] >= w[:, None])).any(1)


def ragged_kernel_phase(engine, rec, profile: bool, launches: int,
                        iters: int) -> dict:
    """K1/K2, or K5/K6 where the engine serves the compressed arena. Each
    also runs on the same worklist over the arena with every tile's cells
    shuffled (its all-pairs branch), held against the plain version and
    timed; the share of meeting items whose two tiles pass the merge
    check (the scalar kernels' at each item's level) is recorded for
    both."""
    import torch
    from repro_torch.kernels import wcsd_query as kwq
    hub, dist, wlev, lo, hi, qidx, stile, ttile, wq, rows = \
        flush_inputs(engine, rec)
    lane = hub.shape[1]
    L = engine.num_levels
    comp = engine.compressed
    name, replaces = RAGGED_KERNELS[(profile, comp)]
    if comp:
        kq, kp = (kwq.wcsd_query_ragged_compressed_cuda,
                  kwq.wcsd_profile_ragged_compressed_cuda)
        pq, pp = (kwq.wcsd_query_ragged_compressed_plain,
                  kwq.wcsd_profile_ragged_compressed_plain)
        plain_extra = (lo,)
    else:
        kq, kp = kwq.wcsd_query_ragged_cuda, kwq.wcsd_profile_ragged_cuda
        pq, pp = kwq.wcsd_query_ragged_plain, kwq.wcsd_profile_ragged_plain
        plain_extra = ()
    if profile:
        def kern(h=hub, d=dist, w=wlev):
            return kp(h, d, w, lo, hi, qidx, stile, ttile, rows, L)

        def plain(h=hub, d=dist, w=wlev):
            return pp(h, d, w, *plain_extra, qidx, stile, ttile, rows, L)
    else:
        def kern(h=hub, d=dist, w=wlev):
            return kq(h, d, w, lo, hi, qidx, stile, ttile, wq)

        def plain(h=hub, d=dist, w=wlev):
            return pq(h, d, w, *plain_extra, qidx, stile, ttile, wq)
    a, b = kern(), plain()
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max().item())
    # data-dependent work: only real items (not pads, which feed the trash
    # row rows - 1) whose tile hub spans meet are joined, each a merge of
    # two tiles plus its hub meets
    real = qidx < rows - 1
    meet = real & (lo[stile] <= hi[ttile]) & (lo[ttile] <= hi[stile])
    n_meet = int(meet.sum().item())
    tiles = torch.unique(torch.cat([stile[meet], ttile[meet]]))
    all_tiles = torch.unique(torch.cat([stile[real], ttile[real]]))
    WL = qidx.shape[0]
    cell = (hub.element_size() + dist.element_size() + wlev.element_size())
    nbytes = (12 * WL + 8 * all_tiles.numel() + cell * lane * tiles.numel()
              + 4 * b.numel() + (4 * wq.numel() if wq is not None else 0))
    hs, ht = hub[stile[meet]], hub[ttile[meet]]
    if comp:                    # decode the hub deltas as the kernel does
        hs = torch.where(hs >= 0, lo[stile[meet]][:, None] + hs.int(), -1)
        ht = torch.where(ht >= 0, lo[ttile[meet]][:, None] + ht.int(), -1)
    meets = hub_meets(hs, ht)
    bms, by = bound_ms(nbytes, join_ops(2 * lane * n_meet, meets, profile))
    out = {"name": name,
           "route": "cuda", "source": "src/repro_torch/csrc/wcsd_query.cu",
           "replaces": replaces,
           "launches": launches, "max_abs_err": err,
           "ms": cuda_ms(kern, iters), "plain_ms": cuda_ms(plain, 2),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "device_ms": device_ms(kern, iters,
                                  name.replace("_compressed", "")),
           "shape": {"worklist": WL, "pad_items": WL - int(real.sum()),
                     "meeting_items": n_meet, "hub_meets": meets,
                     "lane": lane,
                     "bytes_per_cell": cell, "queries": rows - 1}}
    if profile:
        def merge_share(h, d, w):
            ok = mergeable_rows(h, w < 0)
            return float((ok[stile[meet]] & ok[ttile[meet]]).float().mean())
    else:
        lev = wq[qidx[meet]]

        def merge_share(h, d, w):
            return float((mergeable_at(h, d, w, stile[meet], lev)
                          & mergeable_at(h, d, w, ttile[meet], lev))
                         .float().mean())

    out["merge_share"] = merge_share(hub, dist, wlev)
    sh = _shuffled_rows(hub, dist, wlev)
    out["shuffled_merge_share"] = merge_share(*sh)
    a, b = kern(*sh), plain(*sh)
    torch.cuda.synchronize()
    out["shuffled_max_abs_err"] = int((a.long() - b.long()).abs().max()
                                      .item())
    out["max_abs_err"] = max(err, out["shuffled_max_abs_err"])
    out["shuffled_ms"] = cuda_ms(lambda: kern(*sh), max(1, iters // 10))
    del sh
    return out


def segmented_kernel_phase(engine, rec, profile: bool, launches: int,
                           iters: int) -> dict:
    """K7/K8 on the sub-batches of one recorded bucket-pair flush: every
    sub-batch's own launch held against the plain version; the flush as
    the engine launches it (one grouped launch over the sub-batches'
    table) held against the grouped plain version and timed, the heaviest
    (most cell pairs) sub-batch's own launch and the flush's per-sub-batch
    launches back to back timed beside it; and the heaviest sub-batch
    with every row's cells shuffled (unsorted rows, pads mid-row: the
    kernel's all-pairs branch) held against its plain version."""
    import torch
    from repro_torch.kernels import wcsd_segmented as kseg
    L = engine.num_levels
    subs = sub_batches(engine, rec)

    def kern(stq, tiles):
        if profile:
            return kseg.wcsd_profile_segmented_cuda(*tiles, stq[0], stq[1], L)
        return kseg.wcsd_query_segmented_cuda(*tiles, stq[0], stq[1],
                                              stq[2])

    def plain(stq, tiles):
        if profile:
            return kseg.wcsd_profile_segmented_plain(*tiles, stq[0], stq[1],
                                                     L)
        return kseg.wcsd_query_segmented_plain(*tiles, stq[0], stq[1],
                                               stq[2])

    err = 0
    for _, stq, tiles in subs:
        a, b = kern(stq, tiles), plain(stq, tiles)
        err = max(err, int((a.long() - b.long()).abs().max().item()))
    torch.cuda.synchronize()

    def work(sub, stq, tiles):
        """(bytes, ops, hub meets) of one sub-batch: each distinct row read
        once, the row ids and levels, the output; a merge of each query's
        two rows plus its hub meets."""
        n = len(sub.positions)
        Ws, Wt = tiles[0].shape[1], tiles[3].shape[1]
        if sub.bucket_s == sub.bucket_t:
            rows = torch.unique(torch.cat([stq[0], stq[1]])).numel()
            row_bytes = 12 * Ws * rows
        else:
            row_bytes = 12 * (Ws * torch.unique(stq[0]).numel()
                              + Wt * torch.unique(stq[1]).numel())
        out = 4 * n * ((L + 1) if profile else 1)
        nbytes = row_bytes + (8 if profile else 12) * n + out
        meets = hub_meets(tiles[0][stq[0]], tiles[3][stq[1]])
        return nbytes, join_ops(n * (Ws + Wt), meets, profile), meets

    works = [work(*x) for x in subs]

    def pairs(i):          # cell pairs an all-pairs join compares
        return (len(subs[i][0].positions) * subs[i][2][0].shape[1]
                * subs[i][2][3].shape[1])

    heavy = max(range(len(subs)), key=pairs)
    sub, stq, tiles = subs[heavy]
    bms, by = bound_ms(*works[heavy][:2])
    fbms, fby = bound_ms(sum(w[0] for w in works), sum(w[1] for w in works))
    shape = {"sub_batches": len(subs), "queries": len(rec[1]),
             "heaviest": {"bucket_s": sub.bucket_s,
                          "bucket_t": sub.bucket_t,
                          "n": len(sub.positions),
                          "Ws": tiles[0].shape[1],
                          "Wt": tiles[3].shape[1],
                          "hub_meets": works[heavy][2]},
             "flush_hub_meets": sum(w[2] for w in works)}
    # the flush in one launch, staged as the engine stages it
    groups = [(tl[:3], tl[3:], len(sb.positions)) for sb, _, tl in subs]
    staged = kseg.GroupedFlush(
        groups, torch.cat([q for _, q, _ in subs], dim=1).cpu().numpy(),
        engine.device)
    if profile:
        name, replaces = ("wcsd_profile_segmented",
                          "src/repro/kernels/wcsd_query.py:588")

        def flush():
            return kseg.wcsd_profile_segmented_grouped_cuda(staged, L)

        def flush_plain():
            return kseg.wcsd_profile_segmented_grouped_plain(staged, L)
    else:
        name, replaces = ("wcsd_query_segmented",
                          "src/repro/kernels/wcsd_query.py:119")

        def flush():
            return kseg.wcsd_query_segmented_grouped_cuda(staged)

        def flush_plain():
            return kseg.wcsd_query_segmented_grouped_plain(staged)

    got, exp = flush(), flush_plain()
    err = max(err, int((got.long() - exp.long()).abs().max().item()))
    perm = torch.rand(tiles[0].shape, generator=torch.Generator(
        device=engine.device).manual_seed(7),
        device=engine.device).argsort(dim=1)
    shuffled = [x.gather(1, perm) for x in tiles[:3]] + list(tiles[3:])
    a, b = kern(stq, shuffled), plain(stq, shuffled)
    unsorted_err = int((a.long() - b.long()).abs().max().item())
    err = max(err, unsorted_err)
    torch.cuda.synchronize()
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/wcsd_query.cu",
            "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(flush, iters),
            "plain_ms": cuda_ms(flush_plain, 2),
            "bound_ms": fbms, "bound_by": fby, "library_ms": None,
            "per": "flush (one launch)",
            "device_ms": device_ms(flush, iters, name),
            "heaviest_sub_batch_ms": cuda_ms(lambda: kern(stq, tiles),
                                             iters),
            "heaviest_sub_batch_bound_ms": bms,
            "heaviest_sub_batch_bound_by": by,
            "per_sub_batch_flush_ms": cuda_ms(
                lambda: [kern(q, t_) for _, q, t_ in subs],
                max(1, iters // 10)),
            "unsorted_max_abs_err": unsorted_err,
            "unsorted_ms": cuda_ms(lambda: kern(stq, shuffled),
                                   max(1, iters // 10)),
            "shape": shape}


def prune_needs(F, T, hub, dist, wlev, d, row_end, chunk: int = 4096):
    """What one K3 call needs when each row is read in order up to its end
    and a root stops at its first entry that gives a distance <= d (the
    call decides only q > d): per active (root, vertex) cell the prefix of
    its row up to that entry (the whole row where it emits). Returns
    (entries scanned, row entries read once per vertex, distinct T cells
    gathered, distinct active vertices, whole-row entries of those
    vertices, T cells a full scan gathers)."""
    import torch
    B, V = F.shape
    W1 = T.shape[2]
    cap = hub.shape[1]
    L = row_end.clamp(0, cap).long()
    bi, vi = torch.nonzero(F >= 0, as_tuple=True)
    col = torch.arange(cap, device=F.device)
    per_v = torch.zeros(V, dtype=torch.long, device=F.device)
    seen = torch.zeros(B * V * W1, dtype=torch.bool, device=F.device)
    seen_full = torch.zeros_like(seen)
    scanned = 0
    for a0 in range(0, bi.numel(), chunk):
        b_, v_ = bi[a0:a0 + chunk], vi[a0:a0 + chunk]
        h = hub[v_]
        fw = F[b_, v_].clamp(0, W1 - 1)
        inrow = col[None] < L[v_][:, None]
        ok = inrow & (h >= 0) & (wlev[v_] >= fw[:, None])
        tv = T[b_[:, None], h.clamp(0, V - 1).long(), fw[:, None].long()]
        q = dist[v_].clamp_max(1 << 29) + tv.clamp_max(1 << 29)
        first = torch.where(ok & (q <= d), col[None], cap).amin(1)
        n = torch.where(first < cap, first + 1, L[v_])
        scanned += int(n.sum().item())
        per_v.scatter_reduce_(0, v_, n, reduce="amax")
        key = (b_[:, None] * (W1 * V) + fw[:, None] * V
               + h.clamp(min=0)).long()
        seen_full[key[ok]] = True
        seen[key[ok & (col[None] < n[:, None])]] = True
    verts = torch.unique(vi)
    return (scanned, int(per_v.sum().item()), int(seen.sum().item()),
            int(verts.numel()), int(L[verts].sum().item()),
            int(seen_full.sum().item()))


def prune_kernel_phase(cap3, launches: int, step_s: float, floor_s: float,
                       iters: int) -> dict:
    """K3 on the build's heaviest pruning call, with the builder's row ends
    and with the row ends the wrapper computes: held against its plain
    version (exact), timed, and its bound counted from these inputs (what
    the early stop needs; the full scan's bound beside it)."""
    import torch
    from repro_torch.kernels import frontier as kfr
    F, T, hub, dist, wlev, d, row_end = cap3
    if row_end is None:
        fail("the heaviest K3 call was captured without its row ends")
    if not torch.equal(row_end, kfr.row_ends(hub, wlev)):
        fail("the builder's row ends (its host counts) differ from "
             "row_ends of its partial index")
    b = kfr.wc_prune_emit_batched_plain(F, T, hub, dist, wlev, d)
    err = 0
    for rend in (row_end, None):
        a = kfr.wc_prune_emit_batched_cuda(F, T, hub, dist, wlev, d,
                                           row_end=rend)
        err = max(err, int((a.long() - b.long()).abs().max().item()))
    torch.cuda.synchronize()
    B, V = F.shape
    W1 = T.shape[2]
    scanned, rows, t_cells, verts, full_rows, full_t = prune_needs(
        F, T, hub, dist, wlev, d, row_end)
    active = int((F >= 0).sum().item())
    full_scan = int(((F >= 0).sum(0) * row_end.long()).sum().item())
    nbytes = 8 * B * V + 12 * rows + 4 * t_cells
    bms, by = bound_ms(nbytes, 4 * scanned)
    full_bms = bound_ms(8 * B * V + 12 * full_rows + 4 * full_t,
                        4 * full_scan)[0]
    layout = ("level-major [B, W+1, V]" if T.stride() == (W1 * V, 1, V)
              else f"strides {tuple(T.stride())}")
    return {"name": "wc_prune_emit_batched", "route": "cuda",
            "source": "src/repro_torch/csrc/frontier.cu",
            "replaces": "src/repro/kernels/frontier.py:108",
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(lambda: kfr.wc_prune_emit_batched_cuda(
                F, T, hub, dist, wlev, d, row_end=row_end), iters),
            "plain_ms": cuda_ms(lambda: kfr.wc_prune_emit_batched_plain(
                F, T, hub, dist, wlev, d), 2),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "bound_full_scan_ms": full_bms,
            "ms_row_end_computed": cuda_ms(
                lambda: kfr.wc_prune_emit_batched_cuda(
                    F, T, hub, dist, wlev, d), max(1, iters // 5)),
            "cuda_launches_per_call": 1,
            "main_path_mean_ms": step_s * 1e3 / max(launches, 1),
            "build_device_s": step_s, "build_bound_floor_s": floor_s,
            "shape": {"B": B, "V": V, "cap": hub.shape[1], "W1": W1,
                      "round": d, "T_layout": layout, "active": active,
                      "active_vertices": verts,
                      "emitted": int((b >= 0).sum().item()),
                      "scanned_entries": scanned,
                      "full_scan_entries": full_scan,
                      "row_bytes_read": 12 * rows,
                      "row_bytes_whole_rows": 12 * full_rows,
                      "t_cells": t_cells, "t_cells_full_scan": full_t}}


def relax_capture(cap4, iters: int) -> dict:
    """K4 on one captured call: held against its plain version (exact),
    timed (kernel and plain), and its bound counted from these inputs."""
    import torch
    from repro_torch.kernels import frontier as kfr
    emit_w, nbr, lvl, rank, rr, R, row_end = cap4
    a = kfr.wc_relax_batched_cuda(emit_w, nbr, lvl, rank, rr, R,
                                  row_end=row_end)
    b = kfr.wc_relax_batched_plain(emit_w, nbr, lvl, rank, rr, R)
    torch.cuda.synchronize()
    err = max(int((x.long() - y.long()).abs().max().item())
              for x, y in zip(a, b))
    B, V = emit_w.shape
    deg = (nbr >= 0).sum(1)                           # prefix length per row
    elig = rank[None, :] > rr[:, None]                # [B, V]
    scanned = int((elig.long() * deg[None]).sum().item())
    rows_bytes = 8 * int(deg[elig.any(0)].sum().item())
    # emit cells needed: (b, n) with an eligible neighbour v of n (the
    # adjacency is symmetric), each counted once
    needed = 0
    for a0 in range(0, V, 4096):
        nb = nbr[a0:a0 + 4096]
        e = elig[:, nb.clamp(min=0)] & (nb >= 0)[None]
        needed += int(e.any(2).sum().item())
    nbytes = 12 * B * V + 4 * needed + rows_bytes + 4 * (V + B)
    bms, by = bound_ms(nbytes, 2 * scanned)
    return {"max_abs_err": err,
            "ms": cuda_ms(lambda: kfr.wc_relax_batched_cuda(
                emit_w, nbr, lvl, rank, rr, R, row_end=row_end), iters),
            "plain_ms": cuda_ms(lambda: kfr.wc_relax_batched_plain(
                emit_w, nbr, lvl, rank, rr, R), 2),
            "bound_ms": bms, "bound_by": by,
            # the mask pass reads every emit cell once more
            "bound_with_mask_ms": bound_ms(nbytes + 4 * B * V,
                                           2 * scanned)[0],
            "shape": {"B": B, "V": V, "D": nbr.shape[1],
                      "active": int((emit_w >= 0).sum().item()),
                      "scanned_neighbours": scanned}}


def relax_kernel_phase(cap4, cap4_dense, launches: int, step_s: float,
                       iters: int) -> dict:
    """K4's record: round 1 of the middle root batch (the table's row),
    and round 1 of root batch 0 (the hub roots, a dense frontier)."""
    main = relax_capture(cap4, iters)
    dense = relax_capture(cap4_dense, iters)
    return {"name": "wc_relax_batched", "route": "cuda",
            "source": "src/repro_torch/csrc/frontier.cu",
            "replaces": "src/repro/kernels/frontier.py:160",
            "launches": launches,
            "max_abs_err": max(main["max_abs_err"], dense["max_abs_err"]),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_with_mask_ms",
                                    "shape")},
            "library_ms": None, "cuda_launches_per_call": 2,
            "build_device_s": step_s,
            "main_path_mean_ms": step_s * 1e3 / max(launches, 1),
            "dense_capture": dense}


# ------------------------------------------- C1: pads anywhere in a row
def _shuffled_rows(*arrays):
    """The arrays with one random permutation of each row's slots applied
    to all of them (pads land mid-row), made on the card."""
    import torch
    gen = torch.Generator(device=arrays[0].device).manual_seed(16)
    perm = torch.rand(arrays[0].shape, generator=gen,
                      device=arrays[0].device).argsort(dim=1)
    return [a.gather(1, perm) for a in arrays]


def c1_phase(cap3, cap4, cap4_dense) -> dict:
    """K3 and K4 held against their plain versions where pads sit in the
    middle of rows (the fault C1 of earlier versions, which stopped at the
    first pad): the heaviest K3 call and both K4 captures with every
    row's slots shuffled, K4 with pad ids V (read as V - 1, masked by
    level -1), and the smallest failing inputs: K4 with D = 9 and rows
    [n0, -1 x 7, n8], K3 with cap 40 and a feasible entry at slot 32
    behind a pad. The wrappers compute the row ends here."""
    import torch
    from repro_torch.kernels import frontier as kfr
    dev = cap3[0].device
    errs = {}

    def diff(a, b):
        if isinstance(a, tuple):
            return max(diff(x, y) for x, y in zip(a, b))
        return int((a.long() - b.long()).abs().max().item())

    F, T, hub, dist, wlev, d, _ = cap3
    hub, dist, wlev = _shuffled_rows(hub, dist, wlev)
    errs["k3_heaviest_mid_row"] = diff(
        kfr.wc_prune_emit_batched_cuda(F, T, hub, dist, wlev, d),
        kfr.wc_prune_emit_batched_plain(F, T, hub, dist, wlev, d))
    mid_row = int((kfr.row_ends(hub, wlev) > (hub >= 0).sum(1)).sum())
    del hub, dist, wlev
    for name, c in (("k4_middle", cap4), ("k4_dense", cap4_dense)):
        emit_w, nbr, lvl, rank, rr, R, _ = c
        nbr, lvl = _shuffled_rows(nbr, lvl)
        for pad in ("mid_row", "pad_node_V"):
            if pad == "pad_node_V":
                nbr = torch.where(nbr < 0, nbr.shape[0], nbr)
            args = (emit_w, nbr, lvl, rank, rr, R)
            errs[f"{name}_{pad}"] = diff(kfr.wc_relax_batched_cuda(*args),
                                         kfr.wc_relax_batched_plain(*args))
    # the smallest failing inputs of C1
    V, B = 16, 4
    ar = torch.arange(V, dtype=torch.int32, device=dev)
    nbr = torch.full((V, 9), -1, dtype=torch.int32, device=dev)
    lvl = torch.full_like(nbr, -1)
    nbr[:, 0], lvl[:, 0] = (ar - 1) % V, 1
    nbr[:, 8], lvl[:, 8] = (ar + 1) % V, 3
    emit = torch.full((B, V), -1, dtype=torch.int32, device=dev)
    emit[:, 5] = 2
    args = (emit, nbr, lvl, ar, torch.full((B,), -1, dtype=torch.int32,
                                           device=dev),
            torch.full_like(emit, -1))
    got = kfr.wc_relax_batched_cuda(*args)
    errs["k4_d9"] = max(diff(got, kfr.wc_relax_batched_plain(*args)),
                        int((got[0][:, 4] != 2).sum()))
    cap, V = 40, 8
    hub = torch.full((V, cap), -1, dtype=torch.int32, device=dev)
    dist = torch.full_like(hub, INF_DIST)
    wlev = torch.full_like(hub, -1)
    hub[3, 32], dist[3, 32], wlev[3, 32] = 6, 0, 2
    F = torch.full((2, V), -1, dtype=torch.int32, device=dev)
    F[:, 3] = 1
    T = torch.full((2, V, 3), INF_DIST, dtype=torch.int32, device=dev)
    T[:, 6, :] = 0
    got = kfr.wc_prune_emit_batched_cuda(F, T, hub, dist, wlev, 1)
    errs["k3_cap40_slot32"] = max(
        diff(got, kfr.wc_prune_emit_batched_plain(F, T, hub, dist, wlev, 1)),
        int((got[:, 3] != -1).sum()))
    torch.cuda.synchronize()
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        fail(f"C1: K3/K4 differ from their plain versions with pads "
             f"mid-row: {bad}")
    progress("C1: K3 and K4 equal their plain versions with pads mid-row")
    return {"phase": "c1", "max_abs_err": errs,
            "k3_rows_with_mid_row_pads": mid_row,
            "equal_plain": True}


# ------------------------------------------ compressed and bucket-pair
MAIN_PATH = ("wcsd_query_ragged", "wcsd_profile_ragged",
             "wc_prune_emit_batched", "wc_relax_batched")
COMPRESSED_PATH = ("wcsd_query_ragged_compressed",
                   "wcsd_profile_ragged_compressed")
BUCKET_PAIR_PATH = ("wcsd_query_segmented", "wcsd_profile_segmented")


def check_path_launches(what: str, launches: dict, path, expect: dict):
    """Every kernel of the path ran; none outside it did; where ``expect``
    names a count, the kernel ran exactly that often."""
    for k, n in launches.items():
        if k in path and n == 0:
            fail(f"{what}: kernel {k} was not launched")
        if k not in path and n != 0:
            fail(f"{what}: kernel {k} outside the path launched {n} times")
        if k in expect and n != expect[k]:
            fail(f"{what}: kernel {k} launched {n} times, expected "
                 f"{expect[k]}")


def serve_summary(srv, wall, n_req, log) -> dict:
    lat = srv.latency_summary()
    return {"wall_s": wall, "requests_per_s": n_req / wall,
            "server_flushes": srv.stats.batches,
            "query_dispatches": sum(1 for r in log if r[0] == "query"),
            "profile_dispatches": sum(1 for r in log if r[0] == "profile"),
            "dispatch_s": srv.stats.dispatch_time_s,
            "drain_wait_s": srv.stats.drain_wait_s,
            "p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
            "memo_hits": srv.stats.memo_hits,
            "max_batch_seen": srv.stats.max_batch}


def compressed_fallback_phase(idx, engine, qrec, prec, device) -> dict:
    """The V = 2^17 store's compressed arena: its size and overflowed
    tiles. Where any tile overflows, an engine asked for compressed=True
    must serve the uncompressed arena, say so, and answer as the
    uncompressed engine did on the recorded flushes."""
    from repro_torch.core.query import DeviceQueryEngine
    t0 = time.perf_counter()
    comp = idx.labels.compressed_arena()
    encode_s = time.perf_counter() - t0
    ar = engine.arena
    out = {"phase": "compressed_fallback", "V": idx.num_nodes,
           "tiles": comp.num_tiles,
           "overflow_tiles": comp.num_overflow_tiles,
           "overflow_share": comp.num_overflow_tiles / comp.num_tiles,
           "max_tile_hub_span": int((ar.tile_hi - ar.tile_lo).max()),
           "arena_bytes": ar.memory_bytes(),
           "compressed_bytes": comp.memory_bytes(),
           "bytes_ratio": ar.memory_bytes() / comp.memory_bytes(),
           "encode_s": encode_s}
    eng = DeviceQueryEngine(idx, compressed=True, device=device)
    out.update(engine_compressed=eng.compressed,
               compression_overflow=eng.compression_overflow)
    if comp.num_overflow_tiles:
        if eng.compressed or not eng.compression_overflow:
            fail("an overflowing store was served compressed")
        if not (np.array_equal(eng.query(*qrec[1:4]), qrec[4].wait())
                and np.array_equal(eng.query_profile(*prec[1:3]),
                                   prec[4].wait())):
            fail("the compressed=True fallback engine differs from the "
                 "uncompressed engine")
        out["fallback_equals_uncompressed"] = True
    elif not eng.compressed:
        fail("a store with no overflowed tile was not served compressed")
    return out


def compressed_serve_phase(device) -> tuple[dict, list, tuple]:
    """Path 2: V = 2^15, served through WCSDServer(compressed=True) in
    epoch flushes, against an uncompressed server on the same index.
    Returns the phase record, the K5/K6 kernel phases and (index, queries,
    profiles, answers, staircases) for the ladder phase."""
    import torch
    from repro_torch.core.generators import random_queries, scale_free
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    from repro_torch.kernels import _cuda
    V = 1 << LOG2_V_COMPRESSED
    g = scale_free(V, m=4, num_levels=5, seed=0)
    t0 = time.perf_counter()
    idx, _ = build_wc_index_batched_packed(g, batch_size=BATCH,
                                           device=device)
    build_s = time.perf_counter() - t0
    qs = random_queries(g, 1 << LOG2_QUERIES, seed=1)
    ps = random_queries(g, 1 << LOG2_PROFILES, seed=2)[:2]
    ar = idx.labels.arena()
    max_dist = int(ar.dist[ar.hub >= 0].max())
    if max_dist > BF16_EXACT:
        fail(f"V = 2^{LOG2_V_COMPRESSED}: largest distance {max_dist} is "
             f"past bf16's exact range {BF16_EXACT}")
    progress(f"compressed path: V={V} built in {build_s:.1f} s")
    _, out_u, prof_u, _ = serve_epoch(idx, qs, ps, MAX_BATCH, [], device)
    log = []
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    srv, out, prof, wall = serve_epoch(idx, qs, ps, MAX_BATCH, log, device,
                                       compressed=True)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    if srv.engine.compressed is not True:
        fail(f"V = 2^{LOG2_V_COMPRESSED} was not served compressed "
             f"(overflow: {srv.engine.compression_overflow})")
    summ = serve_summary(srv, wall, len(qs[0]) + len(ps[0]), log)
    check_path_launches("compressed serving", launches, COMPRESSED_PATH, {
        "wcsd_query_ragged_compressed": summ["query_dispatches"],
        "wcsd_profile_ragged_compressed": summ["profile_dispatches"]})
    bad = sum(1 for rec in log
              if not np.array_equal(rec[4].wait(), plain_flush(srv.engine,
                                                               rec)))
    if bad:
        fail(f"compressed serving: {bad} flushes differ from the plain path")
    if not (np.array_equal(out, out_u) and np.array_equal(prof, prof_u)):
        fail("compressed serving differs from the uncompressed server")
    comp = idx.labels.compressed_arena()
    progress(f"compressed serving {wall:.1f} s, equal to uncompressed")
    phase = {"phase": "compressed_serve", "V": V, "edges": g.num_edges,
             "build_s": build_s, "entries": idx.size_entries(),
             "max_finite_dist": max_dist, "bf16_exact_to": BF16_EXACT,
             "arena_bytes": ar.memory_bytes(),
             "compressed_bytes": comp.memory_bytes(),
             "bytes_ratio": ar.memory_bytes() / comp.memory_bytes(),
             "overflow_tiles": comp.num_overflow_tiles,
             "engine_compressed": True, "queries": len(qs[0]),
             "profile_queries": len(ps[0]), "max_batch": MAX_BATCH,
             "launches": {k: launches[k] for k in COMPRESSED_PATH},
             "flushes_equal_plain": True, "equal_uncompressed": True,
             **summ}
    qrec = next(r for r in log if r[0] == "query")
    prec = next(r for r in log if r[0] == "profile")
    kernels = [ragged_kernel_phase(srv.engine, qrec, False,
                                   launches[COMPRESSED_PATH[0]], 50),
               ragged_kernel_phase(srv.engine, prec, True,
                                   launches[COMPRESSED_PATH[1]], 50)]
    return phase, kernels, (idx, qs, ps, out, prof)


def bucket_pair_phase(idx, qs, ps, out_ragged, prof_ragged, device
                      ) -> tuple[dict, list]:
    """Path 4: the V = 2^17 index through WCSDServer(dispatch=
    "bucket_pair") in epoch flushes. One K7 launch per scalar flush, one
    K8 launch per profile flush, every sub-batch equal to its plain path,
    the whole stream equal to the ragged server's. Returns the phase
    record and the K7/K8 kernel phases."""
    import torch
    from repro_torch.kernels import _cuda
    log = []
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    srv, out, prof, wall = serve_epoch(idx, qs, ps, MAX_BATCH, log, device,
                                       dispatch="bucket_pair")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    progress(f"bucket-pair serving {wall:.1f} s")
    planned = {"query": 0, "profile": 0}
    flushes = {"query": 0, "profile": 0}
    per_flush, bad = [], 0
    for rec in log:
        got = rec[4].wait()
        subs = sub_batches(srv.engine, rec)
        planned[rec[0]] += len(subs)
        flushes[rec[0]] += 1 if subs else 0
        per_flush.append(len(subs))
        for sub, stq, tiles in subs:
            if not np.array_equal(got[sub.positions],
                                  plain_sub_batch(srv.engine, rec[0], stq,
                                                  tiles)):
                bad += 1
    check_path_launches("bucket-pair serving", launches, BUCKET_PAIR_PATH, {
        "wcsd_query_segmented": flushes["query"],
        "wcsd_profile_segmented": flushes["profile"]})
    if bad:
        fail(f"bucket-pair serving: {bad} sub-batches differ from the "
             "plain path")
    if not (np.array_equal(out, out_ragged)
            and np.array_equal(prof, prof_ragged)):
        fail("bucket-pair serving differs from the ragged server")
    progress("bucket-pair answers equal the plain path and the ragged "
             "server")
    packed = srv.engine.packed
    phase = {"phase": "bucket_pair_serve", "V": idx.num_nodes,
             "bucket_widths": packed.bucket_widths.tolist(),
             "bucket_rows": [len(m) for m in packed.bucket_vertices],
             "tile_bytes": sum(int(x.numel()) * 4 for tl in srv.engine._tiles
                               for x in tl),
             "queries": len(qs[0]), "profile_queries": len(ps[0]),
             "max_batch": MAX_BATCH,
             "sub_batches": planned, "flushes": flushes,
             "sub_batches_per_flush": float(np.mean(per_flush)),
             "max_sub_batches_per_flush": int(max(per_flush)),
             "launches": {k: launches[k] for k in BUCKET_PAIR_PATH},
             "sub_batches_equal_plain": True, "equal_ragged": True,
             **serve_summary(srv, wall, len(qs[0]) + len(ps[0]), log)}
    qrec = next(r for r in log if r[0] == "query")
    prec = next(r for r in log if r[0] == "profile")
    kernels = [segmented_kernel_phase(srv.engine, qrec, False,
                                      launches[BUCKET_PAIR_PATH[0]], 20),
               segmented_kernel_phase(srv.engine, prec, True,
                                      launches[BUCKET_PAIR_PATH[1]], 20)]
    return phase, kernels


# ------------------------------------------------------- padded layout
PADDED_PATH = ("wcsd_query_gathered",)
FRONTIER_PATH = ("frontier_relax_gathered",)


def gathered_kernel_phase(engine, rec, launches: int, iters: int) -> dict:
    """K9 on the gathered rows of one recorded padded flush, and on the
    same rows with every row's cells shuffled (its all-pairs branch), both
    held against the plain version and timed; the share of queries whose
    two rows pass its merge check, for both; the gather's time
    (`ops.gather_padded_rows`, which runs before every K9 launch)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wcsd_query as kwq
    _, s, t, wl, _ = rec
    st = torch.from_numpy(np.stack([s, t, wl]).astype(np.int32)).to(
        engine.device)

    def gather():
        return kops.gather_padded_rows(
            engine.hub, engine.dist, engine.wlev, engine.count, st[0],
            st[1], st[2])

    hs, ds, ht, dt = gather()
    a = kwq.wcsd_query_gathered_cuda(hs, ds, ht, dt)
    b = kwq.wcsd_query_gathered_plain(hs, ds, ht, dt)
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max().item())
    hs2, ds2 = _shuffled_rows(hs, ds)
    ht2, dt2 = _shuffled_rows(ht, dt)
    a = kwq.wcsd_query_gathered_cuda(hs2, ds2, ht2, dt2)
    b = kwq.wcsd_query_gathered_plain(hs2, ds2, ht2, dt2)
    torch.cuda.synchronize()
    shuffled_err = int((a.long() - b.long()).abs().max().item())

    def merge_share(h1, d1, h2, d2):
        ok = (mergeable_rows(h1, d1 >= kwq.DEV_INF)
              & mergeable_rows(h2, d2 >= kwq.DEV_INF))
        return float(ok.float().mean())

    B, L = hs.shape
    meets = hub_meets(hs, ht)
    # the four gathered rows once and the output; a merge join over the
    # store's hub-sorted rows (2L compares a query) plus the meets
    bms, by = bound_ms(4 * 4 * B * L + 4 * B,
                       join_ops(2 * L * B, meets, False))
    return {"name": "wcsd_query_gathered", "route": "cuda",
            "source": "src/repro_torch/csrc/wcsd_query.cu",
            "replaces": "src/repro/kernels/wcsd_query.py:55",
            "launches": launches, "max_abs_err": max(err, shuffled_err),
            "ms": cuda_ms(lambda: kwq.wcsd_query_gathered_cuda(
                hs, ds, ht, dt), iters),
            "plain_ms": cuda_ms(lambda: kwq.wcsd_query_gathered_plain(
                hs, ds, ht, dt), 2),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "gather_ms": cuda_ms(gather, iters),
            "merge_share": merge_share(hs, ds, ht, dt),
            "shuffled_merge_share": merge_share(hs2, ds2, ht2, dt2),
            "shuffled_max_abs_err": shuffled_err,
            "shuffled_ms": cuda_ms(lambda: kwq.wcsd_query_gathered_cuda(
                hs2, ds2, ht2, dt2), max(1, iters // 5)),
            "shape": {"B": B, "L": L, "hub_meets": meets,
                      "cell_pairs": B * L * L}}


def padded_serve_phase(idx, qs, ps, out_ragged, prof_ragged, device
                       ) -> tuple[dict, list]:
    """Path 5: the V = 2^17 index from the padded store through
    WCSDServer(layout="padded", use_pallas=True) in epoch flushes: one K9
    launch per scalar dispatch and no other kernel (profiles are the
    plain padded join), the whole stream equal to the ragged server's,
    served at "primary" with no demotion. Returns the phase record and
    the K9 kernel phase."""
    import torch
    from repro_torch.core.query import padded_chunk_rows
    from repro_torch.kernels import _cuda
    log = []
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    srv, out, prof, wall = serve_epoch(idx, qs, ps, MAX_BATCH, log, device,
                                       layout="padded", use_pallas=True)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    total_s = time.perf_counter() - t0
    summ = serve_summary(srv, wall, len(qs[0]) + len(ps[0]), log)
    check_path_launches("padded serving", launches, PADDED_PATH, {
        "wcsd_query_gathered": summ["query_dispatches"]})
    if srv.mode != "primary" or srv.stats.demotions:
        fail(f"padded serving ran at {srv.mode!r} with "
             f"{srv.stats.demotions} demotions")
    if not (np.array_equal(out, out_ragged)
            and np.array_equal(prof, prof_ragged)):
        fail("padded serving differs from the ragged server")
    eng = srv.engine
    L = int(eng.hub.shape[1])
    progress(f"padded serving {wall:.1f} s (L = {L}), equal to ragged")
    phase = {"phase": "padded_serve", "V": idx.num_nodes, "L": L,
             "padded_bytes": eng.padded_bytes,
             "arena_bytes": idx.labels.arena().memory_bytes(),
             "store_build_s": total_s - wall,
             "profile_chunk_rows": padded_chunk_rows(L),
             "queries": len(qs[0]), "profile_queries": len(ps[0]),
             "max_batch": MAX_BATCH, "mode": srv.mode,
             "demotions": srv.stats.demotions,
             "launches": {k: launches[k] for k in PADDED_PATH},
             "equal_ragged": True, **summ}
    qrec = next(r for r in log if r[0] == "query")
    return phase, [gathered_kernel_phase(eng, qrec,
                                         launches[PADDED_PATH[0]], 10)]


# --------------------------------------------------------- ladder phase
LADDER = ("primary", "uncompressed", "bucket_pair", "oracle")
RUNG_KERNELS = {"primary": {"wcsd_query_ragged_compressed",
                            "wcsd_profile_ragged_compressed"},
                "uncompressed": {"wcsd_query_ragged",
                                 "wcsd_profile_ragged"},
                "bucket_pair": {"wcsd_query_segmented",
                                "wcsd_profile_segmented"},
                "oracle": set()}


def rung_of(engine) -> str:
    if engine.layout == "padded":
        return "oracle"
    if engine.dispatch == "bucket_pair":
        return "bucket_pair"
    return "primary" if engine.compressed else "uncompressed"


class RungLaunches:
    """Engine wrapper attributing every dispatch's kernel launches to the
    ladder rung the wrapped engine serves (launches are counted when a
    wrapper enqueues them, inside the dispatch)."""

    def __init__(self, engine, rung: str, per_rung: dict):
        self._engine, self._rung, self._per_rung = engine, rung, per_rung

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _count(self, fn, *args):
        from repro_torch.kernels import _cuda
        before = dict(_cuda.LAUNCHES)
        try:
            return fn(*args)
        finally:
            acc = self._per_rung.setdefault(self._rung, {})
            for k, n in _cuda.LAUNCHES.items():
                if n != before[k]:
                    acc[k] = acc.get(k, 0) + n - before[k]

    def query_async(self, s, t, wl):
        return self._count(self._engine.query_async, s, t, wl)

    def query_profile_async(self, s, t):
        return self._count(self._engine.query_profile_async, s, t)


def ladder_walk(demotions: int) -> dict:
    """`FaultSchedule` ``fixed`` draws that walk a server whose flushes
    carry a scalar and a profile batch down ``demotions`` rungs of its
    fallback ladder, with ``max_retries=1``: a healthy flush takes two
    draws (scalar, then profile); a raise-raise exhausts the budget and
    demotes, and the batch is served by the next draw; one hang after the
    first demotion costs a timeout retry and one redispatch draw. Healthy
    flushes follow, so ``probe_interval`` of them promote it back."""
    fixed, k = {}, 2                     # flush 1 is healthy
    for i in range(demotions):
        fixed[k] = fixed[k + 1] = "engine_raise"
        k += 4
        if i == 0:
            fixed[k] = "flush_hang"
            k += 3
    return fixed


def ladder_phase(idx, qs, ps, out_comp, prof_comp, device) -> dict:
    """Path 3: the V = 2^15 store through a compressed WCSDServer under the
    flush watchdog, its engines wrapped in a `FaultyEngine` whose fixed
    draws walk it down every rung and a hang the deadline absorbs; then
    healthy flushes promote it back to "primary". Every rung serves going
    down and going up, launching only its own kernels (none at the
    oracle); every answer equals the compressed server's and is
    delivered once, stamped with its rung; the retry counters match the
    schedule."""
    import torch
    from repro_torch.checkpoint.fault import FaultSchedule, FaultyEngine
    from repro_torch.core.resilience import UnknownRequestError
    from repro_torch.core.serve import WCSDServer
    from repro_torch.kernels import _cuda
    demotions = len(LADDER) - 1
    flushes = 4 + 3 * demotions
    per, pper = LADDER_PER, LADDER_PER // 4
    sched = FaultSchedule(fixed=ladder_walk(demotions))
    per_rung: dict = {}
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    srv = WCSDServer(
        idx, max_batch=1 << 20, compressed=True, device=device,
        flush_timeout_ms=LADDER_TIMEOUT_MS, max_retries=1, probe_interval=2,
        backoff_base_ms=1.0, retry_seed=0, memo_capacity=0,
        engine_wrapper=lambda e: RungLaunches(FaultyEngine(e, sched),
                                              rung_of(e), per_rung))
    if [n for n, _ in srv._ladder] != list(LADDER):
        fail(f"ladder {[n for n, _ in srv._ladder]} is not {list(LADDER)}")
    rebuilds = []
    build = srv._build_engine

    def timed_build(cfg):
        t0 = time.perf_counter()
        eng = build(cfg)
        torch.cuda.synchronize()
        rebuilds.append({"rung": srv.mode,
                         "s": time.perf_counter() - t0})
        return eng

    srv._build_engine = timed_build
    s, t, wl = qs
    flush_modes, got, gotp = [], [], []
    t0 = time.perf_counter()
    for f in range(flushes):
        rids = [srv.submit(int(a), int(b), int(c)) for a, b, c in zip(
            s[f * per:(f + 1) * per], t[f * per:(f + 1) * per],
            wl[f * per:(f + 1) * per])]
        prids = [srv.submit_profile(int(a), int(b)) for a, b in zip(
            ps[0][f * pper:(f + 1) * pper], ps[1][f * pper:(f + 1) * pper])]
        srv.flush()
        res = [srv.result_with_mode(r) for r in rids]
        pres = [srv.profile_result_with_mode(r) for r in prids]
        modes = {m for _, m in res} | {m for _, m in pres}
        if len(modes) != 1:
            fail(f"ladder flush {f}: answers stamped with {sorted(modes)}")
        flush_modes.append(modes.pop())
        got += [v for v, _ in res]
        gotp += [v for v, _ in pres]
        for r in rids[:1] + prids[:1]:       # read-once
            try:
                srv.result(r) if r in rids else srv.profile_result(r)
                fail(f"ladder: rid {r} was delivered twice")
            except UnknownRequestError:
                pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, npf = flushes * per, flushes * pper
    if srv.results or srv.profile_results or len(got) != n \
            or len(gotp) != npf:
        fail("ladder: a request was lost or delivered twice")
    if not (np.array_equal(np.array(got, np.int32), out_comp[:n])
            and np.array_equal(np.stack(gotp), prof_comp[:npf])):
        fail("ladder answers differ from the compressed server")
    path = [m for i, m in enumerate(flush_modes)
            if i == 0 or m != flush_modes[i - 1]]
    if path != list(LADDER) + list(LADDER[-2::-1]):
        fail(f"ladder: the flushes walked {path}")
    for rung in LADDER:
        ran = set(per_rung.get(rung, {}))
        if ran != RUNG_KERNELS[rung]:
            fail(f"ladder: at {rung!r} the kernels {sorted(ran)} ran, "
                 f"expected {sorted(RUNG_KERNELS[rung])}")
    st = srv.stats
    want = {"timeout_retries": 1, "error_retries": demotions,
            "exhausted": demotions, "demotions": demotions,
            "promotions": demotions}
    counters = {k: getattr(st, k) for k in want}
    if counters != want or srv.mode != "primary":
        fail(f"ladder counters {counters} (mode {srv.mode!r}), expected "
             f"{want} and 'primary'")
    kinds = sorted({k for _, k in sched.injected})
    if len(sched.injected) != 2 * demotions + 1:
        fail(f"ladder: {sched.injected} injected")
    progress(f"ladder walked {path} in {wall:.1f} s")
    return {"phase": "ladder", "V": idx.num_nodes, "flushes": flushes,
            "queries": n, "profile_queries": npf,
            "flush_timeout_ms": LADDER_TIMEOUT_MS, "rungs": list(LADDER),
            "flush_modes": flush_modes, "walk": path,
            "launches_per_rung": per_rung, "counters": counters,
            "injected": len(sched.injected), "injected_kinds": kinds,
            "draws": sched.draws, "rebuilds": rebuilds, "wall_s": wall,
            "equal_compressed": True, "delivered_once": True}


# ------------------------------------------------- single-root BFS (K10)
def _bfs_levels(task):
    from repro_torch.core.ref import wcsd_bfs_all
    root, w = task
    return wcsd_bfs_all(_BFS_GRAPH, root, w) < INF_DIST


def relax_plain(nbr, lvl, F, R):
    """The plain path of `ops.frontier_relax`: the same gather (-1 at pad
    neighbours), then K10's plain version. Returns (fw_nbr, (newF,
    newR))."""
    import torch
    from repro_torch.kernels import frontier as kfr
    fw = F[nbr.clamp(0, F.shape[0] - 1).long()]
    fw = torch.where(nbr >= 0, fw, -1).to(torch.int32)
    return fw, kfr.frontier_relax_gathered_plain(fw, lvl, R)


def frontier_relax_phase(g, device) -> tuple[dict, list]:
    """Path 6: single-root constrained BFS over the V = 2^17 padded
    adjacency through `ops.frontier_relax`, round by round until no
    vertex is active, from the highest-degree vertex and two seeded
    roots. One K10 launch per round; every round equal to the plain
    version; the final R equal to the host BFS at every level. Returns
    the phase record and the K10 kernel phase (the round with the most
    active vertices)."""
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import frontier as kfr
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    nbr, lvl = (torch.from_numpy(a).to(device)
                for a in g.padded_adjacency())
    V, D = nbr.shape
    W = g.num_levels
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    roots = [int(np.argmax(g.degree()))] + [
        int(x) for x in rng.integers(0, V, BFS_ROOTS - 1)]
    finals, rounds, bad, heavy = [], [], 0, None
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for root in roots:
        F = torch.full((V,), -1, dtype=torch.int32, device=device)
        F[root] = W
        R = F.clone()
        n = 0
        while True:
            active = int((F >= 0).sum().item())
            if not active:
                break
            newF, newR = kops.frontier_relax(nbr, lvl, F, R)
            fw, (pF, pR) = relax_plain(nbr, lvl, F, R)
            if not (torch.equal(newF, pF) and torch.equal(newR, pR)):
                bad += 1
            if heavy is None or active > heavy[0]:
                heavy = (active, fw, R)
            F, R = newF, newR
            n += 1
        rounds.append(n)
        finals.append(R.cpu().numpy())
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    check_path_launches("frontier relaxation", launches, FRONTIER_PATH,
                        {"frontier_relax_gathered": sum(rounds)})
    if bad:
        fail(f"frontier relaxation: {bad} rounds differ from the plain "
             "version")
    ctx = multiprocessing.get_context("spawn")
    tasks = [(r, w) for r in roots for w in range(W + 1)]
    with concurrent.futures.ProcessPoolExecutor(
            8, mp_context=ctx, initializer=_bfs_init, initargs=(g,)) as pool:
        reach = list(pool.map(_bfs_levels, tasks))
    for (root, w), rc in zip(tasks, reach):
        Rf = finals[roots.index(root)]
        if not np.array_equal(Rf >= w, rc):
            fail(f"frontier relaxation from {root}: R >= {w} differs from "
                 "the host BFS")
    progress(f"frontier relaxation: {sum(rounds)} rounds equal the plain "
             "version and the host BFS")
    phase = {"phase": "frontier_relax", "V": V, "D": D, "levels": W,
             "roots": roots, "root_degrees": [int(g.degree()[r])
                                              for r in roots],
             "rounds": rounds, "setup_s": setup_s, "loop_s": loop_s,
             "reached": [int((f >= 0).sum()) for f in finals],
             "launches": {k: launches[k] for k in FRONTIER_PATH},
             "rounds_equal_plain": True, "bfs_equal": True}
    active, fw, R = heavy
    a = kfr.frontier_relax_gathered_cuda(fw, lvl, R)
    b = kfr.frontier_relax_gathered_plain(fw, lvl, R)
    torch.cuda.synchronize()
    err = max(int((x.long() - y.long()).abs().max().item())
              for x, y in zip(a, b))
    # fw_nbr, lvl and R read once, newF and newR written; 2 ops a cell
    bms, by = bound_ms(4 * (2 * V * D + 3 * V), 2 * V * D)
    kern = {"name": "frontier_relax_gathered", "route": "cuda",
            "source": "src/repro_torch/csrc/frontier.cu",
            "replaces": "src/repro/kernels/frontier.py:62",
            "launches": launches[FRONTIER_PATH[0]], "max_abs_err": err,
            "ms": cuda_ms(lambda: kfr.frontier_relax_gathered_cuda(
                fw, lvl, R), 50),
            "plain_ms": cuda_ms(lambda: kfr.frontier_relax_gathered_plain(
                fw, lvl, R), 5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": {"V": V, "D": D, "active": active}}
    return phase, [kern]


# ------------------------------------------------------- the GNN family
GNN_LANDMARKS = 8        # the encodings' landmarks: the top-degree vertices
GNN_CLIP = 32            # `distance_encoding`'s clip
GNN_BFS_SAMPLE = 64      # encoded vertices also checked against the BFS
GNN_STEPS = 4            # AdamW steps per arch and shape
GNN_ARCHS = ("gin-tu", "pna", "gatedgcn")
GNN_RUN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
NEQUIP_RUN_SHAPES = ("molecule", "minibatch_lg")
GNN_PARITY_TOL = 1e-4    # card vs CPU forward, of max |ref| (real nodes)
GNN_SINK_PARITY_TOL = 2e-3  # the sink row, of max |ref| (PNA: 8.9e-4 on an H100)
NEQUIP_ROT_TOL = 1e-4    # rotated energies, of max |E|
GNN_FEATURE_PATH = ("wcsd_query_ragged",)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bfs_dists(task):
    from repro_torch.core.ref import wcsd_bfs_all
    root, w = task
    return wcsd_bfs_all(_BFS_GRAPH, root, w)


def gnn_feature_stage(g, idx, device) -> tuple[dict, np.ndarray]:
    """The feature stage: `data.graphs.distance_encoding` of every vertex
    against the `GNN_LANDMARKS` highest-degree vertices at every level
    below the top one (one `DeviceQueryEngine`, ragged: one K1 launch a
    flush). Every flush is held against the engine's plain path on the
    card; the encodings of `GNN_BFS_SAMPLE` sampled vertices (and of
    every vertex, from the same BFS runs) against the host BFS from each
    landmark at each level, clipped. Returns the record and the
    encodings."""
    import torch
    from repro_torch.core.query import DeviceQueryEngine
    from repro_torch.data import graphs as DG
    from repro_torch.kernels import _cuda
    V = g.num_nodes
    landmarks = np.argsort(-g.degree(), kind="stable")[:GNN_LANDMARKS]
    levels = list(range(g.num_levels))
    eng = DeviceQueryEngine(idx, layout="csr", dispatch="ragged",
                            device=device)
    log = []
    record_flushes(eng, log)
    _sync(device)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    enc = DG.distance_encoding(idx, np.arange(V), landmarks, levels,
                               clip=GNN_CLIP, engine=eng)
    _sync(device)
    stage_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    check_path_launches("gnn feature stage", launches, GNN_FEATURE_PATH,
                        {"wcsd_query_ragged": len(log)})
    t0 = time.perf_counter()
    bad = sum(1 for rec in log
              if not np.array_equal(rec[4].wait(), plain_flush(eng, rec)))
    plain_s = time.perf_counter() - t0
    if bad:
        fail(f"gnn feature stage: {bad} of {len(log)} flushes differ from "
             "the plain path")
    ctx = multiprocessing.get_context("spawn")
    tasks = [(int(lm), w) for w in levels for lm in landmarks]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            8, mp_context=ctx, initializer=_bfs_init, initargs=(g,)) as pool:
        exp = np.stack(list(pool.map(_bfs_dists, tasks)), axis=1)
    bfs_s = time.perf_counter() - t0
    exp = np.minimum(exp, GNN_CLIP).astype(np.float32)
    sample = np.random.default_rng(6).choice(V, GNN_BFS_SAMPLE,
                                             replace=False)
    if not np.array_equal(enc[sample], exp[sample]):
        fail("gnn feature stage: sampled encodings differ from the host BFS")
    if not np.array_equal(enc, exp):
        fail("gnn feature stage: encodings differ from the host BFS")
    n_q = V * len(landmarks) * len(levels)
    progress(f"gnn feature stage: {n_q:,} queries in {stage_s:.2f} s, "
             f"{launches['wcsd_query_ragged']} K1 launches, every flush "
             "equal to the plain path, every vertex to the host BFS")
    rec = {"V": V, "landmarks": [int(x) for x in landmarks],
           "levels": levels, "clip": GNN_CLIP, "queries": n_q,
           "flush": DG.ENCODING_FLUSH, "flushes": len(log),
           "k1_launches": launches["wcsd_query_ragged"],
           "stage_s": stage_s, "queries_per_s": n_q / stage_s,
           "plain_check_s": plain_s, "bfs_s": bfs_s,
           "flushes_equal_plain": True, "bfs_sample": GNN_BFS_SAMPLE,
           "bfs_vertices": V, "bfs_equal": True,
           "mean_encoding": float(enc.mean())}
    return rec, enc


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch.train.tree import flatten_with_paths
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def _to_device(batch: dict, device) -> dict:
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def gnn_train_run(cfg, shape: str, batch: dict, device, steps=GNN_STEPS,
                  rotate=False) -> dict:
    """``steps`` AdamW steps of ``cfg`` (sized for ``shape``) from a seeded
    init on ``batch`` (already on the device): every loss finite, the
    last step re-run from its starting state bit-identical (parameters
    and moments); the median step time, model TFLOP/s, peak memory
    above the run's start, and a `torch.profiler` trace of one more step
    (device busy ms, idle share, the top kernels). ``tflops_real_edges``
    counts the model FLOP over the edges that are not sink self-edges
    (the padding). With ``rotate`` (NequIP) the energies after
    the steps are held invariant under a random rotation of ``pos``."""
    import torch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.models import common as C
    from repro_torch.models import gnn as G
    from repro_torch.models import nequip as NQ
    from repro_torch.train import optim as O
    nequip = isinstance(cfg, NQ.NequIPConfig)
    model = (NQ.NequIP if nequip else G.GNN)(cfg, device=device, seed=0)
    params = C.param_tree(model)
    opt = O.init_opt_state(GC.TRAIN_OPT, params)
    step = GC.make_train_step_for(cfg, shape)
    N, E = GC.padded_sizes(shape)
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    times, losses = [], []
    for i in range(steps):
        prev = (params, opt)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))          # waits for the step
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base
            if torch.device(device).type == "cuda" else None)
    if not np.isfinite(losses).all():
        fail(f"gnn {cfg.name} at {shape}: a loss is not finite: {losses}")
    again = step(*prev, batch)
    if not (_tree_equal(again[0], params) and _tree_equal(again[1], opt)):
        fail(f"gnn {cfg.name} at {shape}: a re-run step is not "
             "bit-identical")
    profile = None
    if torch.device(device).type == "cuda":
        rows, wall = trace_second_call(lambda: step(params, opt, batch))
        busy = sum(ms for _, ms, _ in rows)
        profile = {"device_busy_ms": busy, "wall_ms": wall * 1e3,
                   "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
                   "device_ops": sum(c for *_, c in rows),
                   "top": [{"kernel": n[:100], "ms": ms, "count": c}
                           for n, ms, c in rows[:6]]}
    med = float(np.median(times))
    flops = GC.model_flops(cfg, E, N)
    sink = N - 1
    real_e = int(((batch["edges_src"] != sink)
                  | (batch["edges_dst"] != sink)).sum())
    real_flops = GC.model_flops(cfg, real_e, N)
    out = {"N": N, "E": E, "dtype": getattr(cfg, "compute_dtype",
                                            "float32"),
           "losses": losses, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": med * 1e3, "model_flops": flops,
           "tflops": flops / med / 1e12, "real_edges": real_e,
           "tflops_real_edges": real_flops / med / 1e12, "peak_bytes": peak,
           "rerun_bit_identical": True, "profile": profile}
    if nequip:
        out["edge_chunk"] = GC.nequip_edge_chunk(E)
        out["force_weight"] = GC.nequip_force_weight(shape)
    if rotate:
        from scipy.spatial.transform import Rotation
        R = torch.tensor(Rotation.random(random_state=7).as_matrix(),
                         dtype=torch.float32, device=batch["pos"].device)
        ng = GC.n_graphs_of(cfg, shape)
        chunk = GC.nequip_edge_chunk(E)
        with torch.no_grad():
            e1 = NQ.energy_fn(params, cfg, batch, n_graphs=ng,
                              edge_chunk=chunk)
            e2 = NQ.energy_fn(params, cfg, dict(batch, pos=batch["pos"]
                                                @ R.T), n_graphs=ng,
                              edge_chunk=chunk)
        err = float((e1 - e2).abs().max() / e1.abs().max())
        if not err <= NEQUIP_ROT_TOL:
            fail(f"nequip at {shape}: energies change by {err:.2e} of max "
                 "|E| under a rotation")
        out["rotation_rel_err"] = err
    progress(f"gnn {cfg.name} at {shape}: median step "
             f"{out['median_step_ms']:.2f} ms, {out['tflops']:.3f} TFLOP/s "
             f"({out['tflops_real_edges']:.3f} over real edges), "
             f"losses {[round(x, 4) for x in losses]}")
    return out


def gnn_parity(cfg, batch_np: dict, device) -> dict:
    """One fp32 forward at ``cfg`` (full width, full_graph_sm) on the
    card against the same forward on the CPU, TF32 off on both sides:
    the real nodes within `GNN_PARITY_TOL` of max |ref|, the sink node
    within `GNN_SINK_PARITY_TOL`. The sink takes every padding edge, and
    PNA's std aggregate there is a cancellation over hundreds of equal
    messages."""
    import torch
    from repro_torch.models import common as C
    from repro_torch.models import gnn as G
    model = G.GNN(cfg, device="cpu", seed=0)
    ref = G.forward(C.param_tree(model), cfg, batch_np).double()
    got = G.forward(C.param_tree(model.to(device)), cfg,
                    _to_device(batch_np, device)).double().cpu()
    err = float((got - ref)[:-1].abs().max() / ref[:-1].abs().max())
    err_sink = float((got - ref)[-1].abs().max() / ref.abs().max())
    if not err <= GNN_PARITY_TOL:
        fail(f"gnn {cfg.name}: the card's forward is {err:.2e} of max |ref| "
             "from the CPU's")
    if not err_sink <= GNN_SINK_PARITY_TOL:
        fail(f"gnn {cfg.name}: the card's forward at the sink is "
             f"{err_sink:.2e} of max |ref| from the CPU's")
    return {"rel_err": err, "rel_err_sink": err_sink,
            "tol": GNN_PARITY_TOL, "sink_tol": GNN_SINK_PARITY_TOL}


def gnn_phase(g, idx, device) -> dict:
    """Path 12: the GNN family on the card. The feature stage (every
    vertex of the V = 2^17 graph encoded by `distance_encoding` through
    K1); GIN, PNA and GatedGCN at `get_config()` width, each at the
    padded shapes of full_graph_sm, molecule and minibatch_lg (a real
    `NeighborSampler` block over ``g``, bf16), `GNN_STEPS` AdamW steps a
    shape; one fp32 full_graph_sm forward per arch against the CPU;
    NequIP at `get_config()` on molecule (the force loss) and
    minibatch_lg (energy only, the reference's edge chunk)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.kernels import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    features, _ = gnn_feature_stage(g, idx, device)
    t0 = time.perf_counter()
    batches = {shape: GC.cell_batch(shape, seed=1, graph=g)
               for shape in GNN_RUN_SHAPES}
    batch_s = time.perf_counter() - t0
    on_card = {shape: _to_device(b, device) for shape, b in batches.items()}
    _sync(device)
    _cuda.reset_launch_counts()
    archs = {}
    for arch in GNN_ARCHS:
        base = get_arch(arch).get_config()
        archs[arch] = {shape: gnn_train_run(GC.shape_config(base, shape),
                                            shape, on_card[shape], device)
                       for shape in GNN_RUN_SHAPES}
        archs[arch]["card_vs_cpu"] = gnn_parity(
            GC.shape_config(base, "full_graph_sm"),
            batches["full_graph_sm"], device)
    nq = get_arch("nequip").get_config()
    archs["nequip"] = {shape: gnn_train_run(GC.shape_config(nq, shape),
                                            shape, on_card[shape], device,
                                            rotate=True)
                       for shape in NEQUIP_RUN_SHAPES}
    _sync(device)
    train_launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if train_launches:
        fail(f"gnn training launched kernels of the port: {train_launches}")
    mb = batches["minibatch_lg"]
    return {"phase": "gnn", "features": features, "batch_s": batch_s,
            "minibatch_block": {
                "seeds": GC.MINIBATCH_SEEDS,
                "fanouts": list(GC.MINIBATCH_FANOUTS),
                "sink_edges": int((mb["edges_dst"] == len(mb["feat"]) - 1
                                   ).sum())},
            "archs": archs, "wall_s": time.perf_counter() - t_phase}


# -------------------------------------------------------- dynamic index
LOG2_V_DYN = 12          # the dynamic index: scale_free(2^12, m=4, 5 levels)
LOG2_DYN_QUERIES = 18    # served scalar queries per graph version
LOG2_DYN_PROFILES = 14   # served profile queries per graph version
DYN_UPDATES = 2          # update batches, each 1 insert + 1 delete
WAL_PROBES = 8           # fsynced WAL appends timed alone
CHAOS = dict(steps=200, seed=3, crash_step=100)  # the acceptance schedule
DYN_DIR = os.path.join(ROOT, "build", "dynamic")


def dyn_mutation(g, k: int):
    """Update batch k: one insert at the middle quality level between
    vertices k and V/2 + k (an upsert where the edge exists) and one
    delete of the k-th edge."""
    mid = float(g.levels[g.num_levels // 2])
    e = int(np.flatnonzero(g.edges_src < g.edges_dst)[k])
    return ([(k, g.num_nodes // 2 + k, mid)],
            [(int(g.edges_src[e]), int(g.edges_dst[e]))])


def check_bfs_sample(engine, g, seed: int, what: str) -> None:
    """``BFS_PAIRS`` random pairs answered by ``engine`` (profiles, and
    scalar queries at every level) against the host BFS of ``g``."""
    rng = np.random.default_rng(seed)
    V, W = g.num_nodes, g.num_levels
    bs_ = rng.integers(0, V, BFS_PAIRS)
    bt_ = rng.integers(0, V, BFS_PAIRS)
    got = engine.query_profile(bs_, bt_)
    got_s = np.stack([engine.query(bs_, bt_, np.full(len(bs_), w, np.int32))
                      for w in range(W + 1)], axis=1)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            8, mp_context=ctx, initializer=_bfs_init, initargs=(g,)) as pool:
        exp = np.array(list(pool.map(
            _bfs_row, [(int(a), int(b)) for a, b in zip(bs_, bt_)])))
    if not (np.array_equal(got, exp) and np.array_equal(got_s, exp)):
        fail(f"{what}: sampled answers differ from the host BFS")


def check_ragged_flushes(what: str, srv, log, launches: dict) -> None:
    """Every logged flush was one K1 (scalar) or K2 (profile) launch, no
    other kernel ran, and every flush equals the plain path."""
    nq = sum(1 for r in log if r[0] == "query")
    np_ = sum(1 for r in log if r[0] == "profile")
    check_path_launches(what, launches, MAIN_PATH[:2], {
        "wcsd_query_ragged": nq, "wcsd_profile_ragged": np_})
    bad = sum(1 for rec in log
              if not np.array_equal(rec[4].wait(),
                                    plain_flush(srv.engine, rec)))
    if bad:
        fail(f"{what}: {bad} flushes differ from the plain path")


def delta_flush_record(engine, rec, profile: bool, T0, iters: int) -> dict:
    """K1 (or K2) on one recorded flush of a ragged engine, held against
    its plain version and timed (CUDA events and device time), with the
    share of meeting items whose tiles pass the merge check, overall and
    over the items that touch a tile at or past ``T0`` (the delta region
    of a dynamic index's arena; None for a static one)."""
    import torch
    from repro_torch.kernels import wcsd_query as kwq
    hub, dist, wlev, lo, hi, qidx, stile, ttile, wq, rows = \
        flush_inputs(engine, rec)
    L = engine.num_levels
    if profile:
        name = "wcsd_profile_ragged"

        def kern():
            return kwq.wcsd_profile_ragged_cuda(hub, dist, wlev, lo, hi, qidx,
                                                stile, ttile, rows, L)

        def plain():
            return kwq.wcsd_profile_ragged_plain(hub, dist, wlev, qidx, stile,
                                                 ttile, rows, L)
        ok = mergeable_rows(hub, wlev < 0)
        merge = ok[stile] & ok[ttile]
    else:
        name = "wcsd_query_ragged"

        def kern():
            return kwq.wcsd_query_ragged_cuda(hub, dist, wlev, lo, hi, qidx,
                                              stile, ttile, wq)

        def plain():
            return kwq.wcsd_query_ragged_plain(hub, dist, wlev, qidx, stile,
                                               ttile, wq)
        lev = wq[qidx]
        merge = (mergeable_at(hub, dist, wlev, stile, lev)
                 & mergeable_at(hub, dist, wlev, ttile, lev))
    a, b = kern(), plain()
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max().item())
    real = qidx < rows - 1
    meet = real & (lo[stile] <= hi[ttile]) & (lo[ttile] <= hi[stile])
    delta = ((stile >= T0) | (ttile >= T0)) if T0 is not None \
        else torch.zeros_like(meet)
    n_m = int(meet.sum().item())
    n_dm = int((meet & delta).sum().item())
    return {"name": name, "max_abs_err": err,
            "ms": cuda_ms(kern, iters), "plain_ms": cuda_ms(plain, 2),
            "device_ms": device_ms(kern, iters, name),
            "worklist": int(qidx.shape[0]),
            "meeting_items": n_m,
            "delta_items": int((real & delta).sum().item()),
            "delta_meeting_items": n_dm,
            "merge_share": int((merge & meet).sum().item()) / max(n_m, 1),
            "delta_merge_share": (int((merge & meet & delta).sum().item())
                                  / n_dm if n_dm else None)}


def dynamic_phase(device) -> dict:
    """Path 7: the dynamic index at V = 2^12 (see the module docstring).
    The caller sets the launch counts to 0 just before; the path's counts
    are read at its end, before the kernels' own comparisons and timings,
    and the chaos schedule is counted on its own after them. Returns the
    phase record."""
    import shutil
    import torch
    from repro_torch.checkpoint.ckpt import (UpdateWAL, load_packed_index,
                                             save_packed_index)
    from repro_torch.checkpoint.fault import run_chaos_schedule
    from repro_torch.core.generators import random_queries, scale_free
    from repro_torch.core.serve import WCSDServer
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    from repro_torch.kernels import _cuda

    V = 1 << LOG2_V_DYN
    shutil.rmtree(DYN_DIR, ignore_errors=True)
    os.makedirs(DYN_DIR)
    phase_t0 = time.perf_counter()
    g = scale_free(V, m=4, num_levels=5, seed=0)
    qs = random_queries(g, 1 << LOG2_DYN_QUERIES, seed=1)
    ps = random_queries(g, 1 << LOG2_DYN_PROFILES, seed=2)[:2]
    n_req = len(qs[0]) + len(ps[0])

    def since(before: dict) -> dict:
        torch.cuda.synchronize()
        return {k: n - before[k] for k, n in _cuda.LAUNCHES.items()}

    # 1. build on the card (K3/K4), checkpoint v0, serve it statically
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    idx0, bstats = build_wc_index_batched_packed(g, batch_size=BATCH,
                                                 device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check_path_launches("dynamic: build", since(before), MAIN_PATH[2:], {})
    ckpt = os.path.join(DYN_DIR, "base_v0.wcx")
    save_packed_index(ckpt, idx0, graph_version=0)
    st_log = []
    before = dict(_cuda.LAUNCHES)
    st_srv, _, _, st_wall = serve_epoch(idx0, qs, ps, MAX_BATCH, st_log,
                                        device)
    check_ragged_flushes("dynamic: static serving", st_srv, st_log,
                         since(before))
    progress(f"dynamic: V={V} built in {build_s:.1f} s, served statically "
             f"in {st_wall:.1f} s")

    # 2-4. two update batches through a WAL-backed dynamic server; after
    # each, the stream served equals a card build from scratch of the
    # mutated graph and the host BFS, one K1 / K2 launch a flush
    wal = os.path.join(DYN_DIR, "updates.wal")
    srv = WCSDServer(idx0, graph=g, max_batch=MAX_BATCH,
                     compact_threshold=None, wal_path=wal, device=device)
    updates, first = [], None
    for k in range(DYN_UPDATES):
        ins, dels = dyn_mutation(srv.index.graph, k)
        t0 = time.perf_counter()
        ustats = srv.apply_updates(ins, dels)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        if srv.index.delta.is_empty():
            fail(f"dynamic: update {k} left an empty delta")
        log = []
        record_flushes(srv.engine, log)
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = srv.query_many(*qs)
        prof = srv.query_profile_many(*ps)
        wall = time.perf_counter() - t0
        check_ragged_flushes(f"dynamic: update {k}", srv, log, since(before))
        t0 = time.perf_counter()
        fresh, _ = build_wc_index_batched_packed(srv.index.graph,
                                                 batch_size=BATCH,
                                                 device=device)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        _, f_out, f_prof, _ = serve_epoch(fresh, qs, ps, MAX_BATCH, [],
                                          device)
        if not (np.array_equal(out, f_out) and np.array_equal(prof, f_prof)):
            fail(f"dynamic: update {k}: answers differ from a build from "
                 "scratch of the mutated graph")
        check_bfs_sample(srv.engine, srv.index.graph, 3 + k,
                         f"dynamic: update {k}")
        T0 = srv.index.base.labels.arena().num_tiles
        if first is None:
            first = (srv.engine, next(r for r in log if r[0] == "query"),
                     next(r for r in log if r[0] == "profile"), T0)
        updates.append({
            "inserts": ins, "deletes": dels, "update_apply_s": apply_s,
            **ustats, "arena_tiles": srv.engine.arena.num_tiles,
            "delta_tiles": srv.engine.arena.num_tiles - T0,
            "wall_s": wall, "requests_per_s": n_req / wall,
            "query_dispatches": sum(1 for r in log if r[0] == "query"),
            "profile_dispatches": sum(1 for r in log if r[0] == "profile"),
            "fresh_build_s": fresh_s, "equal_fresh_build": True,
            "bfs_pairs": BFS_PAIRS, "bfs_equal": True})
        progress(f"dynamic: update {k} applied in {apply_s:.1f} s "
                 f"({ustats['affected_roots']} affected roots, "
                 f"{ustats['delta_rows']} delta rows), served in "
                 f"{wall:.1f} s, equal to a fresh build and the BFS")
    last_out, last_prof = out, prof

    # dynamic against static serving on the same graph, interleaved
    rps = {"static": [], "dynamic": []}
    for side in ("static", "dynamic", "dynamic", "static"):
        _, _, _, w = serve_epoch(fresh if side == "static" else srv.index,
                                 qs, ps, MAX_BATCH, [], device)
        rps[side].append(n_req / w)

    # 7. warm start: the v0 checkpoint plus the WAL's two records
    t0 = time.perf_counter()
    base, _ = load_packed_index(ckpt)
    rep = WCSDServer(base, graph=g, max_batch=MAX_BATCH,
                     compact_threshold=None, wal_path=wal, device=device)
    replayed = rep.replay_wal()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    if replayed != DYN_UPDATES or rep.graph_version != srv.graph_version:
        fail(f"dynamic: replay applied {replayed} records to version "
             f"{rep.graph_version}, the server is at {srv.graph_version}")
    if not (np.array_equal(rep.query_many(*qs), last_out)
            and np.array_equal(rep.query_profile_many(*ps), last_prof)):
        fail("dynamic: the replayed server's answers differ")
    progress(f"dynamic: WAL replayed in {replay_s:.1f} s")

    # 5. compaction on the card, byte-identical to the fresh build
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    cstats = srv.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    compact_launches = since(before)
    check_path_launches("dynamic: compaction", compact_launches,
                        MAIN_PATH[2:], {})
    for name in ("order", "rank", "levels"):
        if not np.array_equal(getattr(srv.index.base, name),
                              getattr(fresh, name)):
            fail(f"dynamic: compacted {name} differs from the fresh build")
    for name in ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
                 "bucket_of", "slot_of"):
        a, b = getattr(srv.index.base.labels, name), getattr(fresh.labels,
                                                             name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"dynamic: compacted PackedLabels.{name} differs from the "
                 "fresh build")
    if not srv.index.delta.is_empty() or srv.wal.records():
        fail("dynamic: compaction left a delta or WAL records behind")

    # 6. WCX round trip of the compacted base
    path = os.path.join(DYN_DIR, "base_compacted.wcx")
    t0 = time.perf_counter()
    save_packed_index(path, srv.index.base, graph_version=srv.graph_version)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, hdr = load_packed_index(path)
    load_s = time.perf_counter() - t0
    if hdr["graph_version"] != srv.graph_version or \
            loaded.checksums() != fresh.checksums():
        fail("dynamic: the loaded index differs from the compacted one")
    _, l_out, l_prof, _ = serve_epoch(loaded, qs, ps, MAX_BATCH, [], device)
    if not (np.array_equal(l_out, last_out)
            and np.array_equal(l_prof, last_prof)):
        fail("dynamic: the loaded index serves other answers")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    check_path_launches("dynamic", launches, MAIN_PATH, {})
    path_s = time.perf_counter() - phase_t0
    progress(f"dynamic: compacted in {compact_s:.1f} s, byte-identical; "
             f"WCX round trip {save_s:.2f} / {load_s:.2f} s")

    # the kernels on the first delta-extended flush against the static one
    eng, qrec, prec, T0 = first
    kern = {"static": [delta_flush_record(st_srv.engine, r, r[0] ==
                                          "profile", None, 20)
                       for r in (next(r for r in st_log if r[0] == "query"),
                                 next(r for r in st_log
                                      if r[0] == "profile"))],
            "delta_extended": [delta_flush_record(eng, qrec, False, T0, 20),
                               delta_flush_record(eng, prec, True, T0, 20)]}
    for side, recs in kern.items():
        for r in recs:
            if r["max_abs_err"]:
                fail(f"dynamic: {r['name']} on the {side} arena differs "
                     f"from its plain version ({r['max_abs_err']})")
    for r in kern["delta_extended"]:
        if not r["delta_meeting_items"] or r["delta_merge_share"] != 1.0:
            fail(f"dynamic: {r['name']}: merge share "
                 f"{r['delta_merge_share']} over "
                 f"{r['delta_meeting_items']} delta items")

    # the WAL's fsynced append, alone
    probe = UpdateWAL(os.path.join(DYN_DIR, "probe.wal"))
    t0 = time.perf_counter()
    for k in range(WAL_PROBES):
        probe.append(*dyn_mutation(g, k), graph_version=k + 1)
    wal_append_s = (time.perf_counter() - t0) / WAL_PROBES

    # 8. the chaos schedule on the card, counted on its own
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    chaos = run_chaos_schedule(dict(device=device),
                               workdir=os.path.join(DYN_DIR, "chaos"),
                               **CHAOS)
    torch.cuda.synchronize()
    chaos_s = time.perf_counter() - t0
    chaos_launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
    if chaos["final_mode"] != "primary" or chaos["crashes"] != 1 or \
            chaos["answered"] != chaos["submitted"] or \
            not all(chaos_launches.get(k) for k in MAIN_PATH[:2]):
        fail(f"dynamic: chaos schedule {chaos}, launches {chaos_launches}")
    progress(f"dynamic: chaos schedule passed in {chaos_s:.1f} s")
    return {"phase": "dynamic", "V": V, "edges": g.num_edges,
            "levels": g.num_levels, "queries": len(qs[0]),
            "profile_queries": len(ps[0]), "max_batch": MAX_BATCH,
            "build_s": build_s, "rounds": bstats["rounds"],
            "entries": bstats["entries"], "static_wall_s": st_wall,
            "static_requests_per_s": n_req / st_wall,
            "updates": updates,
            "interleaved_requests_per_s": rps,
            "dynamic_over_static": [d / s_ for d, s_ in
                                    zip(rps["dynamic"], rps["static"])],
            "compact_s": compact_s, "compact_rounds": cstats["rounds"],
            "compact_launches": {k: compact_launches[k]
                                 for k in MAIN_PATH[2:]},
            "compact_equal_fresh_build": True,
            "wcx_bytes": os.path.getsize(path), "save_s": save_s,
            "load_s": load_s, "replay_s": replay_s,
            "replayed_records": replayed, "replay_equal": True,
            "wal_append_s": wal_append_s, "path_s": path_s,
            "launches": {k: launches[k] for k in MAIN_PATH},
            "kernels": kern, "chaos": chaos, "chaos_s": chaos_s,
            "chaos_launches": chaos_launches}


# ---------------------------------------------------- sharded serving
SHARDS = 8               # logical shards of the serving meshes
LOG2_SHARD_Q = 16        # queries of each CSR sharded engine check
LOG2_SHARD_P = 12        # profiles of the same
LOG2_SHARD_SERVE = (18, 14)  # queries, profiles of each served run
SHARD_PATH = {  # the kernel each placement's scalar / profile call runs
    ("csr", "ragged", False): ("wcsd_query_ragged", "wcsd_profile_ragged"),
    ("csr", "ragged", True): ("wcsd_query_ragged_compressed",
                              "wcsd_profile_ragged_compressed"),
    ("csr", "bucket_pair", False): ("wcsd_query_segmented",
                                    "wcsd_profile_segmented"),
    ("padded", "dense", False): ("wcsd_query_gathered", None)}


def _launched(before: dict) -> dict:
    from repro_torch.kernels import _cuda
    return {k: n - before[k] for k, n in _cuda.LAUNCHES.items()
            if n != before[k]}


def sharded_engine_check(name, idx, mesh, qs, ps, out, prof, **kw) -> dict:
    """One `ShardedQueryEngine` over a prefix of a stream: its answers
    must equal the device server's, and every placement must launch its
    kernel once per shard per call (the padded layout's profiles are the
    plain join and launch none)."""
    import torch
    from repro_torch.core.query import ShardedQueryEngine
    from repro_torch.kernels import _cuda
    s, t, wl = qs
    t0 = time.perf_counter()
    eng = ShardedQueryEngine(idx, mesh=mesh, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want_sharded = kw.get("device_budget_bytes") is not None
    if (eng.mode == "sharded_labels") != want_sharded:
        fail(f"sharded {name}: placement {eng.mode}")
    if kw.get("compressed") and not eng.compressed:
        fail(f"sharded {name}: not served compressed")
    q_kernel, p_kernel = SHARD_PATH[(eng.layout, eng.dispatch,
                                     eng.compressed)]
    rec = {"leg": name, "mode": eng.mode, "mesh": list(mesh.shape),
           "layout": eng.layout, "dispatch": eng.dispatch,
           "compressed": eng.compressed, "queries": len(s),
           "profiles": len(ps[0]), "build_s": build_s,
           "store_bytes_per_device": eng.store_bytes_per_device}
    for kind, call, exp, kernel in (
            ("query", lambda: eng.query(s, t, wl), out, q_kernel),
            ("profile", lambda: eng.query_profile(*ps), prof, p_kernel)):
        torch.cuda.synchronize()
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        got = call()
        rec[f"{kind}_s"] = time.perf_counter() - t0
        launched = _launched(before)
        rec[f"{kind}_launches"] = launched
        if not np.array_equal(got, exp):
            fail(f"sharded {name}: {kind} answers differ from the device "
                 f"server ({int((got != exp).sum())} of {len(got)})")
        want = {} if kernel is None else {kernel: eng.ndev}
        if launched != want:
            fail(f"sharded {name}: a {kind} call launched {launched}, "
                 f"expected {want}")
    del eng
    torch.cuda.empty_cache()
    progress(f"sharded {name}: equal to the device server "
             f"({rec['query_s']:.2f} + {rec['profile_s']:.2f} s)")
    return rec


def row_sharded_breakdown(engine, qs, ps) -> dict:
    """The row-sharded flush of ``MAX_BATCH`` queries (and a profile flush
    of a quarter as many): the host plan's ms, `ragged_tile_gather`'s
    event ms, G and the bytes it moves, the balanced worklist lengths
    against the unbalanced slices' max and mean; and shard 0's K1 and K2
    launches (the engine's own `_shard_launch_args`) held against their
    plain versions, exactly, timed."""
    import torch
    from repro_torch.distributed.collectives import ragged_tile_gather
    from repro_torch.kernels import wcsd_query as kwq
    s, t, wl = (a[:MAX_BATCH] for a in qs)
    stq = engine._stage_ragged(s, t, wl)
    t0 = time.perf_counter()
    bal, _ = engine._balance_ragged(stq)
    uniq = engine._gather_plan(bal)
    plan_s = time.perf_counter() - t0
    fl = engine._row_sharded_flush(stq)
    tc = engine._tile_cnt_np
    b = stq.shape[1] // engine.ndev
    slices = (tc[stq[0]].astype(np.int64) * tc[stq[1]]).reshape(
        engine.ndev, b).sum(1)
    args, wq = engine._shard_launch_args(fl, 0)
    h, d, w, lo, hi, qidx, sloc, tloc, _ = args
    lane = int(h.shape[1])
    cell = sum(x.element_size() for x in (h, d, w))
    G = int(uniq.shape[1])
    gather_ms = cuda_ms(lambda: ragged_tile_gather(
        engine._blocks, uniq.reshape(-1), engine._tiles_per), 10)
    rec = {"flush_queries": len(s), "host_plan_ms": plan_s * 1e3,
           "tile_gather_ms": gather_ms, "G": G,
           "gather_bytes": int(engine.ndev * G * lane * cell),
           "distinct_tiles": [int(len(np.unique(u))) for u in uniq],
           "balanced_worklist_lens": fl.lens,
           "unbalanced_max_slice": int(slices.max()),
           "unbalanced_mean_slice": float(slices.mean())}
    L = engine.num_levels
    a = kwq.wcsd_query_ragged_cuda(h, d, w, lo, hi, qidx, sloc, tloc, wq)
    p = kwq.wcsd_query_ragged_plain(h, d, w, qidx, sloc, tloc, wq)
    torch.cuda.synchronize()
    rec["shard_k1_max_abs_err"] = int((a.long() - p.long()).abs().max())
    rec["shard_k1_ms"] = cuda_ms(lambda: kwq.wcsd_query_ragged_cuda(
        h, d, w, lo, hi, qidx, sloc, tloc, wq), 20)
    rec["shard_k1_plain_ms"] = cuda_ms(lambda: kwq.wcsd_query_ragged_plain(
        h, d, w, qidx, sloc, tloc, wq), 2)
    pf = engine._row_sharded_flush(engine._stage_ragged(
        ps[0][:MAX_BATCH // 4], ps[1][:MAX_BATCH // 4]))
    (h, d, w, lo, hi, qidx, sloc, tloc, _), _ = \
        engine._shard_launch_args(pf, 0)
    rows = pf.stq.shape[1] // engine.ndev + 1
    a = kwq.wcsd_profile_ragged_cuda(h, d, w, lo, hi, qidx, sloc, tloc,
                                     rows, L)
    p = kwq.wcsd_profile_ragged_plain(h, d, w, qidx, sloc, tloc, rows, L)
    torch.cuda.synchronize()
    rec["shard_k2_max_abs_err"] = int((a.long() - p.long()).abs().max())
    rec["shard_k2_ms"] = cuda_ms(lambda: kwq.wcsd_profile_ragged_cuda(
        h, d, w, lo, hi, qidx, sloc, tloc, rows, L), 20)
    rec["shard_k2_plain_ms"] = cuda_ms(
        lambda: kwq.wcsd_profile_ragged_plain(h, d, w, qidx, sloc, tloc,
                                              rows, L), 2)
    if rec["shard_k1_max_abs_err"] or rec["shard_k2_max_abs_err"]:
        fail(f"row-sharded shard 0: K1/K2 over the gathered tiles differ "
             f"from their plain versions ({rec['shard_k1_max_abs_err']}, "
             f"{rec['shard_k2_max_abs_err']})")
    return rec


def sharded_serve(idx, qs, ps, out, prof, device, **kw) -> dict:
    """One epoch server over the stream, launch counts reset just before
    and read just after: a sharded server must launch K1 ``ndev`` times
    per scalar flush and K2 ``ndev`` times per profile flush, a device
    server once each; the answers must equal ``out`` / ``prof``."""
    import torch
    from repro_torch.kernels import _cuda
    log = []
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    srv, got, gprof, wall = serve_epoch(idx, qs, ps, MAX_BATCH, log, device,
                                        **kw)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    summ = serve_summary(srv, wall, len(qs[0]) + len(ps[0]), log)
    ndev = getattr(srv.engine, "ndev", 1)
    check_path_launches(f"{kw.get('backend', 'device')} server", launches,
                        MAIN_PATH[:2], {
                            "wcsd_query_ragged":
                                ndev * summ["query_dispatches"],
                            "wcsd_profile_ragged":
                                ndev * summ["profile_dispatches"]})
    if not (np.array_equal(got, out) and np.array_equal(gprof, prof)):
        fail(f"{kw} server answers differ from the device server")
    return {"backend": kw.get("backend", "device"),
            "mode": getattr(srv.engine, "mode", "device"), "ndev": ndev,
            "launches": {k: launches[k] for k in MAIN_PATH[:2]}, **summ}


def sharded_phase(idx, qs, ps, out_e, prof_e, comp_world, device) -> dict:
    """Path 8: the sharded serving engine on the card. An 8-shard mesh and
    a 2x4 (pod, data) mesh; every placement of every layout on the V =
    2^17 index (and the compressed arena on the V = 2^15 world) over a
    prefix of its stream, equal to the device server; the row-sharded
    flush's breakdown and shard 0's K1/K2 against their plain versions;
    epoch servers (replicated and row-sharded labels, interleaved with a
    device server) over 2^18 queries + 2^14 profiles; and the dry run
    (`launch.dryrun.run_serve` / `run_chaos`, full size) on the card."""
    import torch
    from repro_torch.kernels._cuda import resolve_device
    from repro_torch.launch.dryrun import run_chaos, run_serve
    from repro_torch.launch.mesh import make_serving_mesh
    t_phase = time.perf_counter()
    card = resolve_device(device)
    mesh = make_serving_mesh([card] * SHARDS)
    mesh24 = make_serving_mesh([card] * SHARDS, multi_pod=True)
    rec = {"phase": "sharded", "shards": SHARDS,
           "cuda_device_count": torch.cuda.device_count(),
           "physical_devices": len(mesh.physical_devices()),
           "meshes": [list(mesh.shape), list(mesh24.shape)]}

    def pre(stream, n):
        return tuple(a[:n] for a in stream)

    nq, np_ = 1 << LOG2_SHARD_Q, 1 << LOG2_SHARD_P
    q16, p12 = pre(qs, nq), pre(ps, np_)
    o16, r12 = out_e[:nq], prof_e[:np_]
    legs = []
    for name, m, kw in (
            ("ragged-replicated", mesh, {}),
            ("ragged-row-sharded", mesh, {"device_budget_bytes": 1}),
            ("ragged-replicated-2x4", mesh24, {}),
            ("ragged-row-sharded-2x4", mesh24, {"device_budget_bytes": 1}),
            ("bucket-pair-replicated", mesh, {"dispatch": "bucket_pair"}),
            ("bucket-pair-row-sharded", mesh, {"dispatch": "bucket_pair",
                                              "device_budget_bytes": 1}),
            ("padded-replicated", mesh, {"layout": "padded"}),
            ("padded-row-sharded", mesh, {"layout": "padded",
                                          "device_budget_bytes": 1})):
        legs.append(sharded_engine_check(name, idx, m, q16, p12, o16, r12,
                                         **kw))
    cidx, cqs, cps, cout, cprof = comp_world
    for name, kw in (("compressed-replicated", {}),
                     ("compressed-row-sharded", {"device_budget_bytes": 1})):
        legs.append(sharded_engine_check(
            name, cidx, mesh, pre(cqs, nq), pre(cps, np_), cout[:nq],
            cprof[:np_], compressed=True, **kw))
    rec["engines"] = legs

    from repro_torch.core.query import ShardedQueryEngine
    eng = ShardedQueryEngine(idx, mesh=mesh, device_budget_bytes=1)
    rec["row_sharded_flush"] = row_sharded_breakdown(eng, qs, ps)
    del eng
    progress(f"row-sharded flush: {rec['row_sharded_flush']}")

    nq, np_ = (1 << n for n in LOG2_SHARD_SERVE)
    qs18, ps14 = pre(qs, nq), pre(ps, np_)
    o18, r14 = out_e[:nq], prof_e[:np_]
    runs = []
    for kw in ({}, {"backend": "sharded", "mesh": mesh},
               {"backend": "sharded", "mesh": mesh,
                "device_budget_bytes": 1},
               {"backend": "sharded", "mesh": mesh,
                "device_budget_bytes": 1},
               {"backend": "sharded", "mesh": mesh}, {}):
        runs.append(sharded_serve(idx, qs18, ps14, o18, r14, device, **kw))
        progress(f"served {runs[-1]['backend']} {runs[-1]['mode']}: "
                 f"{runs[-1]['requests_per_s']:.0f} requests/s")
    rec["served"] = runs

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        try:
            run_serve(quick=False, device=card)
        except SystemExit as err:
            fail(f"dry run on the card: {err}")
    rec["dryrun_serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        try:
            chaos = run_chaos(quick=False, device=card)
        except SystemExit as err:
            fail(f"chaos dry run on the card: {err}")
    rec["dryrun_chaos_s"] = time.perf_counter() - t0
    rec["chaos"] = {tag: {k: s[k] for k in (
        "submitted", "answered", "injected", "demotions", "promotions",
        "error_retries", "timeout_retries", "final_mode")}
        for tag, s in chaos}
    rec["phase_s"] = time.perf_counter() - t_phase
    progress(f"sharded phase {rec['phase_s']:.1f} s")
    return rec


# ------------------------------------------------------ xDeepFM serving
XDEEPFM_PATH = ("cin_layer",)
P99_BATCH, P99_BATCHES = 512, 256      # serve_p99: batches served
BULK_BATCH, BULK_BATCHES = 262144, 4   # serve_bulk
N_CAND, TOP_K = 1_000_000, 100         # retrieval_cand (top 100 fixed)
WARMUP_BATCHES = 2                     # serve_p99 batches before the clock
# K11 timing: iterations at serve_p99 (kernel, plain and einsum), then
# at serve_bulk, where one H = 200 call takes ~0.1-0.3 s
P99_ITERS, P99_PLAIN_ITERS, BULK_ITERS, BULK_PLAIN_ITERS = 50, 5, 3, 1
ANCHOR_ROWS = 8                        # rows checked against float64 (CPU)
# CIN at the model's init scale: max |out| ~1e-3, 1e-4, 1e-5 by layer, so
# every comparison there is relative to the layer's own max |ref|. fp32
# sums of H*M = 7,800 terms in another order err by ~sqrt(H*M) * 2^-24 ~
# 5e-6 of that; 1e-4 leaves 20x. K11's 3xTF32 products drop only
# lo*lo (~2^-22 of each), which is of the same order (an emulation:
# ~5e-7 of the layer's max, `tests/test_torch_kernels.py`). Logits (the
# CIN share is ~1e-4 of them) are checked beside cin_feat, not instead of
# it.
CIN_REL_TOL = 1e-4
LOGIT_REL_TOL = 1e-5


def rel_err(got, exp) -> float:
    """max |got - exp| / max |exp| (float64, on the host)."""
    g = got.detach().double().cpu()
    e = exp.detach().double().cpu()
    return float((g - e).abs().max() / e.abs().max())


def layer_rel_errs(got, exp, widths) -> list:
    """`rel_err` of each layer's columns of pooled CIN features."""
    out, a = [], 0
    for k in widths:
        out.append(rel_err(got[:, a:a + k], exp[:, a:a + k]))
        a += k
    return out


def cin_inputs(model, emb) -> list:
    """(x1, x0, w) of every CIN layer of one forward over ``emb``, the
    layers' inputs made by K11 as the forward makes them."""
    from repro_torch.kernels import cin_fuse as kcin
    xs, xk, i = [], emb, 0
    while hasattr(model.cin, f"w{i}"):
        w = getattr(model.cin, f"w{i}")
        xs.append((xk, emb, w))
        xk = kcin.cin_layer_cuda(xk, emb, w)
        i += 1
    return xs


def cin_layer_timing(cfg, layer: int, x1, x0, w, iters: int,
                     plain_iters: int) -> dict:
    """K11, its plain version and one `torch.einsum` on one layer's
    inputs. The einsum builds the [B, H, M, D] outer product, so where B
    passes the plain version's chunk it is timed on a chunk's rows
    (``library_rows``) and ``library_ms`` is null. K11 runs the layer's
    FLOP three times over on the tensor cores (3xTF32): its bound is that
    over the dense TF32 rate; the fp32 bound (the FLOP once, outside the
    tensor cores) is kept beside it."""
    import torch
    from repro_torch.configs.xdeepfm_arch import cin_flops
    from repro_torch.kernels import cin_fuse as kcin
    B, H, M, D, K = kcin.cin_shapes(x1, x0, w)
    flop = cin_flops(cfg, B)[layer]
    nbytes = x1.element_size() * (x1.numel() + x0.numel() + w.numel()) \
        + 4 * B * K * D
    to = 3 * flop / TF32_FLOPS_PER_S * 1e3
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    rows = min(B, kcin.cin_chunk_rows(H, M, D))
    lib = cuda_ms(lambda: torch.einsum("bhd,bmd,khm->bkd", x1[:rows],
                                       x0[:rows], w), plain_iters)
    ms = cuda_ms(lambda: kcin.cin_layer_cuda(x1, x0, w), iters)
    return {"layer": layer, "B": B, "H": H, "M": M, "D": D, "K": K,
            "flop": flop, "bytes": nbytes, "ms": ms,
            "tflop_per_s": flop / ms * 1e-9,
            "splits": kcin.cin_plan(x1.device, B, H, M, D, K,
                                    x1.dtype == torch.bfloat16)[0],
            "plain_ms": cuda_ms(lambda: kcin.cin_layer_plain(x1, x0, w),
                                plain_iters),
            "bound_ms": max(to, tb),
            "bound_by": "operations" if to >= tb else "bytes",
            "bound_3xtf32_ms": to,
            "bound_fp32_ms": max(flop / FP32_FLOPS_PER_S * 1e3, tb),
            "library_ms": lib if rows == B else None,
            "library_rows": rows, "library_rows_ms": lib}


def xdeepfm_phase(cfg, device, p99=(P99_BATCH, P99_BATCHES),
                  bulk=(BULK_BATCH, BULK_BATCHES), n_cand=N_CAND,
                  ) -> tuple[dict, list]:
    """Path 8: the xDeepFM serving path at ``cfg``'s widths: `XDeepFM`
    from a seeded CUDA generator serving ``p99`` = (batch, batches) and
    ``bulk`` from `CTRStream`, host to host (numpy ids in, numpy logits
    out; the stream's generation off the clock), and one query against
    ``n_cand`` candidates. One K11 launch per CIN layer of each forward,
    no other kernel. Then K11 is held against its plain version on
    unit-normal inputs (at the reference test's tolerance), on the real
    activations of every layer of one serve_p99 batch and one bulk
    chunk, and through the pooled ``cin_feat`` (relative to each layer's
    max), and 8 rows against the plain forward in float64 on the CPU;
    the retrieval top 100 against float64 on the host. Returns the phase
    record and K11's kernel record."""
    import dataclasses
    import torch
    from repro_torch.configs.xdeepfm_arch import _SHAPE_SPECS
    from repro_torch.data.recsys import CTRStream
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import cin_fuse as kcin
    from repro_torch.models import xdeepfm as X
    # full fp32 in every product, on both sides of every comparison
    # (these are PyTorch's defaults for matmul; cuDNN's is True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    widths, L = cfg.cin_layers, len(cfg.cin_layers)
    t0 = phase_t0 = time.perf_counter()
    model = X.XDeepFM(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pbytes = {n: p.numel() * p.element_size()
              for n, p in model.named_parameters()}
    progress(f"xdeepfm: {cfg.total_rows} embedding rows, "
             f"{sum(pbytes.values())} parameter bytes, set up in "
             f"{setup_s:.1f} s")

    # ------------------------- the serving path, launches counted
    finite = True
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    forwards = 0
    with torch.inference_mode():
        stream = CTRStream(cfg.field_vocabs, cfg.field_offsets, p99[0],
                           seed=0)
        for _ in range(WARMUP_BATCHES):
            model(stream.next_batch()["ids"]).cpu()
            forwards += 1
        lat = []
        for _ in range(p99[1]):
            ids = stream.next_batch()["ids"]
            t1 = time.perf_counter()
            out = model(ids).cpu().numpy()
            lat.append(time.perf_counter() - t1)
            forwards += 1
            finite &= bool(np.isfinite(out).all())
        check_ids = ids
        logits_k, feat_k = model(check_ids, return_cin=True)
        forwards += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # earlier phases' and weights
        bstream = CTRStream(cfg.field_vocabs, cfg.field_offsets, bulk[0],
                            seed=1)
        bulk_s = []
        for _ in range(bulk[1]):
            ids = bstream.next_batch()["ids"]
            t1 = time.perf_counter()
            out = model(ids).cpu().numpy()
            bulk_s.append(time.perf_counter() - t1)
            forwards += 1
            finite &= bool(np.isfinite(out).all())
        bulk_ids = ids
        peak = torch.cuda.max_memory_allocated()
        cand = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (n_cand, cfg.embed_dim)).astype(np.float32)).to(device)
        qids = check_ids[:1]
        X.retrieval_scores(model, qids, cand)            # warm-up
        t1 = time.perf_counter()
        _, (_, top_i) = X.retrieval_scores(model, qids, cand)
        top_i = top_i.cpu().numpy()
        retrieval_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    check_path_launches("xdeepfm", launches, XDEEPFM_PATH,
                        {"cin_layer": L * forwards})
    if not finite:
        fail("xdeepfm: a served logit is not finite")
    lat_us = np.asarray(lat) * 1e6
    progress(f"xdeepfm: serve_p99 p50 {np.percentile(lat_us, 50):.0f} us, "
             f"p99 {np.percentile(lat_us, 99):.0f} us; serve_bulk "
             f"{np.median(bulk_s) * 1e3:.1f} ms a batch; retrieval "
             f"{retrieval_ms:.2f} ms; {launches['cin_layer']} K11 launches "
             f"= {L} x {forwards} forwards")

    # ------------------------- K11 against its plain version
    # K11's arithmetic; every PyTorch product here stays full fp32
    checks = {"tf32": "3xtf32", "matmul_allow_tf32": False,
              "cin_rel_tol": CIN_REL_TOL, "logit_rel_tol": LOGIT_REL_TOL}
    g = torch.Generator(device=device)
    g.manual_seed(5)
    M, D, K = cfg.n_sparse, cfg.embed_dim, widths[0]
    unit = []
    for B, H in ((p99[0], widths[0]), (p99[0], M),
                 (kcin.cin_chunk_rows(widths[0], M, D), widths[0])):
        x = [torch.randn(s, generator=g, device=device)
             for s in ((B, H, D), (B, M, D), (K, H, M))]
        a, b = kcin.cin_layer_cuda(*x), kcin.cin_layer_plain(*x)
        atol = 1e-5 * H * M ** 0.5   # tests/test_kernels.py's tolerance
        err = (a - b).abs()
        if not bool((err <= atol + 1e-4 * b.abs()).all()):
            fail(f"xdeepfm: K11 differs from its plain version on "
                 f"unit-normal inputs at (B, H, M, D, K) = "
                 f"{(B, H, M, D, K)}: max abs err {float(err.max())}")
        unit.append({"B": B, "H": H, "M": M, "D": D, "K": K,
                     "max_abs_err": float(err.max()), "atol": atol,
                     "rtol": 1e-4})
    checks["unit_normal"] = unit
    emb, lin = model.embed_rows(check_ids)
    p99_in = cin_inputs(model, emb)
    real, same = [], []
    for x1, x0, w in p99_in:
        a = kcin.cin_layer_cuda(x1, x0, w)
        same.append(bool(torch.equal(a, kcin.cin_layer_cuda(x1, x0, w))))
        real.append(rel_err(a, kcin.cin_layer_plain(x1, x0, w)))
    xk, pooled = emb, []
    for i in range(L):
        xk = kcin.cin_layer_plain(xk, emb, getattr(model.cin, f"w{i}"))
        pooled.append(xk.sum(-1))
    feat_rel = layer_rel_errs(feat_k, torch.cat(pooled, -1), widths)
    n = ANCHOR_ROWS
    tree64 = {g: {k: v.to("cpu", torch.float64) for k, v in
                  X.param_tree(model)[g].items()} for g in ("cin", "mlp")}
    log64, feat64 = X.head(tree64["cin"], tree64["mlp"],
                           model.bias.double().cpu(),
                           emb[:n].double().cpu(), lin[:n].double().cpu())
    anchor_feat = layer_rel_errs(feat_k[:n], feat64, widths)
    anchor_logits = rel_err(logits_k[:n], log64)
    q64 = model.embed[torch.as_tensor(qids[0], device=device).long()]
    s64 = cand.double().cpu().numpy() @ q64.double().cpu().numpy().mean(0)
    top64 = np.argsort(-s64, kind="stable")[:TOP_K]
    checks.update(real_activations_rel=real, cin_feat_rel=feat_rel,
                  anchor_rows=n, anchor_cin_feat_rel=anchor_feat,
                  anchor_logits_rel=anchor_logits,
                  retrieval_top_equal=bool(np.array_equal(top_i, top64)),
                  logits_finite=finite)
    if max(real + feat_rel + anchor_feat) > CIN_REL_TOL:
        fail(f"xdeepfm: CIN outside {CIN_REL_TOL} of the layer's max: "
             f"real activations {real}, cin_feat {feat_rel}, float64 "
             f"anchor {anchor_feat}")
    if anchor_logits > LOGIT_REL_TOL:
        fail(f"xdeepfm: logits {anchor_logits} from the float64 anchor")
    if not checks["retrieval_top_equal"]:
        fail("xdeepfm: the retrieval top 100 differs from float64")
    progress(f"xdeepfm: K11 equals its plain version (real activations "
             f"{max(real):.2e}, cin_feat {max(feat_rel):.2e}, anchor "
             f"{max(anchor_feat):.2e} of the layer max); top "
             f"{TOP_K} equal")

    # ------------------------- K11 timed at both serve shapes
    p99_rec = [cin_layer_timing(cfg, i, *xs, P99_ITERS, P99_PLAIN_ITERS)
               for i, xs in enumerate(p99_in)]
    bemb, _ = model.embed_rows(bulk_ids)
    bulk_in = cin_inputs(model, bemb)
    x1, x0, w = bulk_in[1 if L > 1 else 0]
    rows = kcin.cin_chunk_rows(x1.shape[1], M, D)
    x1c, x0c = x1[:rows].contiguous(), x0[:rows].contiguous()
    a = kcin.cin_layer_cuda(x1c, x0c, w)
    same.append(bool(torch.equal(a, kcin.cin_layer_cuda(x1c, x0c, w))))
    checks["bulk_chunk_rel"] = rel_err(a, kcin.cin_layer_plain(x1c, x0c, w))
    del a, x1c, x0c
    checks["deterministic"] = same
    if not all(same):
        fail(f"xdeepfm: two K11 launches on the same inputs differ "
             f"(p99 layers, bulk chunk: {same})")
    if checks["bulk_chunk_rel"] > CIN_REL_TOL:
        fail(f"xdeepfm: K11 on a bulk chunk is {checks['bulk_chunk_rel']} "
             "of the layer max from its plain version")
    bulk_rec = [cin_layer_timing(cfg, i, *xs, BULK_ITERS, BULK_PLAIN_ITERS)
                for i, xs in enumerate(bulk_in)]
    del bulk_in, bemb
    phase_s = time.perf_counter() - phase_t0
    progress(f"xdeepfm: K11 timed at both serve shapes; phase {phase_s:.1f} s")
    lat_s = float(np.sum(lat))
    phase = {"phase": "xdeepfm", "config": dataclasses.asdict(cfg),
             "total_rows": cfg.total_rows, "param_bytes": pbytes,
             "param_bytes_total": sum(pbytes.values()), "setup_s": setup_s,
             "phase_s": phase_s,
             "serve_p99": {"batch": p99[0], "batches": p99[1],
                           "p50_us": float(np.percentile(lat_us, 50)),
                           "p99_us": float(np.percentile(lat_us, 99)),
                           "mean_us": float(lat_us.mean()),
                           "samples_per_s": p99[0] * p99[1] / lat_s},
             "serve_bulk": {"batch": bulk[0], "batches": bulk[1],
                            "ms_per_batch": [s * 1e3 for s in bulk_s],
                            "median_ms": float(np.median(bulk_s)) * 1e3,
                            "samples_per_s": bulk[0] * bulk[1]
                            / float(np.sum(bulk_s)),
                            "max_memory_allocated": peak,
                            "allocated_before": base,
                            "peak_above_before": peak - base},
             "retrieval_cand": {"n_cand": n_cand, "top_k": TOP_K,
                                "ms": retrieval_ms},
             "shapes": {k: _SHAPE_SPECS[k] for k in
                        ("serve_p99", "serve_bulk", "retrieval_cand")},
             "forwards": forwards,
             "launches": {k: launches[k] for k in XDEEPFM_PATH},
             "checks": checks}
    main = p99_rec[1 if L > 1 else 0]
    x1, x0, w = p99_in[1 if L > 1 else 0]
    a, b = kcin.cin_layer_cuda(x1, x0, w), kcin.cin_layer_plain(x1, x0, w)
    kern = {"name": "cin_layer", "route": "cuda",
            "source": "src/repro_torch/csrc/cin_fuse.cu",
            "replaces": "src/repro/kernels/cin_fuse.py:39",
            "launches": launches[XDEEPFM_PATH[0]],
            "max_abs_err": float((a - b).abs().max()),
            # fp32 sums in another order: judged relative to the layer's
            # max (CIN_REL_TOL), not exactly as the int32 kernels are
            "max_abs_tol": CIN_REL_TOL * float(b.abs().max()),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_3xtf32_ms",
                                    "bound_fp32_ms", "library_ms")},
            "arithmetic": "3xtf32", "deterministic": all(same),
            "shape": {k: main[k] for k in ("B", "H", "M", "D", "K",
                                           "splits")},
            "serve_p99_layers": p99_rec, "serve_bulk_layers": bulk_rec}
    return phase, [kern]


# ------------------------------------------------ xDeepFM training (K11, K12)
TRAIN_PATH = ("cin_layer", "cin_layer_narrow", "cin_weight_grad")
TRAIN_BATCH = 65536          # the train_batch shape
TRAIN_STEPS = 8              # Trainer steps, then the runner's
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_STEP = 5          # the runner's injected failure
GRAD_CHECK_ROWS = 2048       # the card-vs-plain gradient check's batch
# K12 and K11's backward calls timed on the step's own inputs
TRAIN_ITERS, TRAIN_PLAIN_ITERS = 2, 1
TRAIN_DIR = os.path.join(ROOT, "build", "train_ckpt")
# K12 sums B*D = 655,360 products per output in fp32 (16,384 a slice,
# then 40 slices in order): ~sqrt(16,384) * 2^-24 ~ 1e-5 of the largest;
# K11's backward calls are K11 (3xTF32): both are held as K11 is, within
# CIN_REL_TOL of each output's max |ref|. Loss and accumulated /
# compressed steps: float32 sums in another order.
TRAIN_LOSS_REL_TOL = 1e-5


@contextlib.contextmanager
def plain_on_card():
    """Every `ops` wrapper takes its plain version, whatever the device:
    the plain path on the card, to hold the kernels' path against."""
    from repro_torch.kernels import ops as kops
    real = kops._on_card
    kops._on_card = lambda x, what: False
    try:
        yield
    finally:
        kops._on_card = real


@contextlib.contextmanager
def capture_cin_calls(calls: list):
    """Records the arguments of every K11 (``("cin_layer", x1, x0, w)``)
    and K12 (``("cin_weight_grad", g, x1, x0)``) call the CIN's forward and
    backward make through `ops`."""
    from repro_torch.kernels import ops as kops
    fwd, wgrad = kops._cin_forward, kops.cin_weight_grad

    def cin(x1, x0, w):
        calls.append(("cin_layer", x1, x0, w))
        return fwd(x1, x0, w)

    def dw(g, x1, x0):
        calls.append(("cin_weight_grad", g, x1, x0))
        return wgrad(g, x1, x0)

    kops._cin_forward, kops.cin_weight_grad = cin, dw
    try:
        yield
    finally:
        kops._cin_forward, kops.cin_weight_grad = fwd, wgrad


def train_launches_per_step(cfg) -> dict:
    """K11 and K12 launches of one train step (float32): K11 once a layer
    forward (K = the layer's width, M = the fields) and backward, dx1
    once (K' = the layer's input width H) and dx0 once per part of x0'
    (K' = the fields, M' = H: one part where the call is narrow, else
    split where the wide kernel cannot hold x0'); each K11 call on the
    narrow kernel where K' <= 64, else on the wide one; K12 once a
    layer. At `get_config()`'s widths: 5 wide, 4 narrow, 3 K12."""
    import torch
    from repro_torch.kernels import cin_fuse as kcin
    out = {"cin_layer": 0, "cin_layer_narrow": 0, "cin_weight_grad": 0}
    M = cfg.n_sparse

    def k11(K, parts=1):
        kind = ("cin_layer_narrow" if kcin.cin_narrow(K, torch.float32)
                else "cin_layer")
        out[kind] += parts

    for H, K in zip([M] + list(cfg.cin_layers[:-1]), cfg.cin_layers):
        k11(K)                                        # forward
        k11(H)                                        # dx1
        k11(M, len(kcin.cin_m_parts(H, kcin.cin_narrow(
            M, torch.float32))))                      # dx0
        out["cin_weight_grad"] += 1
    return out


def train_kernel_record(kind: str, args, iters: int, plain_iters: int
                        ) -> dict:
    """One captured K11 or K12 call at its step's shapes: the kernel
    against its plain version (relative to the output's max) and against
    itself (bit-identical), its time, its plain version's, one
    `torch.einsum` of the same function, and its bound. Both are fp32
    contractions of the same FLOP, bounded as K11 is bounded everywhere:
    three times the FLOP at the dense TF32 rate (3xTF32, the card's peak
    for fp32-accurate products), or the bytes, whichever is larger; the
    FLOP once at the SIMT fp32 rate stands beside it (``bound_fp32_ms``).
    The einsum runs on the whole batch (at B = 65,536 it fits the H100's
    80 GB at every training shape). ``kernel`` names the K11 kernel the
    call took (narrow or wide)."""
    import torch
    from repro_torch.kernels import cin_fuse as kcin
    if kind == "cin_layer":
        x1, x0, w = args
        B, H, M, D, K = kcin.cin_shapes(x1, x0, w)
        cuda, plain = kcin.cin_layer_cuda, kcin.cin_layer_plain
        eq, lib_args = "bhd,bmd,khm->bkd", (x1, x0, w)
        out_numel = B * K * D
    else:
        g, x1, x0 = args
        B, H, M, D, K = kcin.cin_grad_shapes(g, x1, x0)
        cuda, plain = kcin.cin_weight_grad_cuda, kcin.cin_weight_grad_plain
        eq, lib_args = "bhd,bmd,bkd->khm", (x1, x0, g)
        out_numel = K * H * M
    a, again, b = cuda(*args), cuda(*args), plain(*args)
    torch.cuda.synchronize()
    flop = 2.0 * B * K * H * M * D
    nbytes = 4.0 * (sum(x.numel() for x in args) + out_numel)
    to = 3 * flop / TF32_FLOPS_PER_S * 1e3
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"kind": kind, "B": B, "H": H, "M": M, "D": D, "K": K,
           "flop": flop, "bytes": nbytes,
           "max_abs_err": float((a - b).abs().max()),
           "max_abs_tol": CIN_REL_TOL * float(b.abs().max()),
           "rel_err": rel_err(a, b), "deterministic": bool(torch.equal(
               a, again))}
    rec["library_rel_err"] = rel_err(torch.einsum(eq, *lib_args), b)
    del a, again, b
    lib = cuda_ms(lambda: torch.einsum(eq, *lib_args), plain_iters)
    ms = cuda_ms(lambda: cuda(*args), iters)
    rec.update(ms=ms, tflop_per_s=flop / ms * 1e-9,
               plain_ms=cuda_ms(lambda: plain(*args), plain_iters),
               bound_ms=max(to, tb),
               bound_by="operations" if to >= tb else "bytes",
               bound_3xtf32_ms=max(to, tb),
               bound_fp32_ms=max(flop / FP32_FLOPS_PER_S * 1e3, tb),
               library_ms=lib)
    if kind == "cin_layer":
        narrow = kcin.cin_narrow(K, x1.dtype)
        rec["kernel"] = "cin_layer_narrow" if narrow else "cin_layer"
        rec["splits"] = 1 if narrow else kcin.cin_plan(
            x1.device, B, H, M, D, K, False)[0]
    else:
        rec["splits"] = kcin.cin_grad_plan(g.device, B, H, M, D, K)
    return rec


def trace_second_call(fn) -> tuple[list, float]:
    """(rows, wall s) of the second of two calls of ``fn`` under a
    `torch.profiler` CUDA trace: rows (name, device ms, count) by device
    time, descending; wall the call's host time between two syncs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    wall = 0.0
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = e.cuda_time_total if t is None else t
        if t:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows, wall


def step_profile(fn, per_step: dict) -> dict:
    """Device time of one call of ``fn`` by kernel, from a
    `torch.profiler` trace of the second of two calls (the first warms
    the trace up: a trace of one call alone has shown none of the
    forward's K11 launches): K11's kernels (wide: the W image, the 3xTF32
    GEMM, its split sum; narrow: its w images and its GEMM), K12's (its
    GEMM, its split sum), and everything else, with the top ten kernels
    by device time. ``launches_in_trace`` counts the three GEMM kernels;
    ``complete`` says whether they match ``per_step``. None where the
    trace shows no device time."""
    rows, wall = trace_second_call(fn)
    if not rows:
        return None

    def kernel(name, subs):
        return any(s in name.split("(")[0] for s in subs)

    group = {"k11_ms": ("cin_layer_kernel", "cin_w_image_kernel",
                        "cin_split_sum_kernel"),
             "k11_narrow_ms": ("cin_narrow_kernel",
                               "cin_narrow_w_image_kernel"),
             "k12_ms": ("cin_weight_grad_kernel",
                        "cin_grad_split_sum_kernel")}
    gemm = {"cin_layer": ("cin_layer_kernel",),
            "cin_layer_narrow": ("cin_narrow_kernel",),
            "cin_weight_grad": ("cin_weight_grad_kernel",)}
    out = {k: sum(ms for name, ms, _ in rows if kernel(name, subs))
           for k, subs in group.items()}
    seen = {k: sum(c for name, _, c in rows if kernel(name, subs))
            for k, subs in gemm.items()}
    busy = sum(ms for _, ms, _ in rows)
    out.update(device_busy_ms=busy, other_ms=busy - sum(out.values()),
               wall_ms=wall * 1e3, idle_share=max(0.0, 1 - busy / (
                   wall * 1e3)),
               launches_in_trace=seen, complete=seen == dict(per_step),
               top=[{"kernel": n[:120], "ms": ms, "count": c}
                    for n, ms, c in rows[:10]])
    return out


def xdeepfm_train_phase(cfg, device, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                        grad_rows=GRAD_CHECK_ROWS) -> tuple[dict, list]:
    """Path 10: xDeepFM training at ``cfg``'s widths through the port's
    training entry points: `XDeepFM` weights from seed 0 as a parameter
    tree, `CTRStream(batch, seed=0)` (step s reads the stream at cursor
    s), `make_train_step_for(cfg)` (AdamW, lr 1e-3, no weight decay). A
    `Trainer` with a `CheckpointManager` (every 4 steps) runs ``steps``
    steps, launches counted (per step: K11 once a layer forward, dx1 and
    dx0 backward, K12 once a layer). Then a `FaultTolerantRunner` over
    the same steps with a failure injected at step 5 must end bit for bit
    on the Trainer's parameters and moments. One step with
    ``accum_steps=4`` and one with ``compress_grads=True`` are held
    against the first step; a whole step's gradient on the card against
    the plain path on the card at ``grad_rows`` rows; K12 and K11's
    forward and backward calls of one step against their plain versions,
    timed; a traced step. Returns the phase record and K12's kernel
    record (K11's records at the train shapes go into the phase
    record)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.checkpoint.fault import FaultTolerantRunner
    from repro_torch.configs.xdeepfm_arch import (TRAIN_OPT,
                                                  make_train_step_for,
                                                  train_flops)
    from repro_torch.data.recsys import CTRStream
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import cin_fuse as kcin
    from repro_torch.models import xdeepfm as X
    from repro_torch.train.grad_compress import quantize_int8
    from repro_torch.train.loop import Trainer, value_and_grad
    from repro_torch.train.optim import global_norm, init_opt_state
    from repro_torch.train.tree import flatten_with_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_t0 = time.perf_counter()
    L = len(cfg.cin_layers)

    def batch_for_step(s, rows=batch):
        st = CTRStream(cfg.field_vocabs, cfg.field_offsets, rows, seed=0)
        st.set_cursor(s)
        return st.next_batch()

    params0 = X.param_tree(X.XDeepFM(cfg, device=device, seed=0))
    opt0 = init_opt_state(TRAIN_OPT, params0)
    step = make_train_step_for(cfg)
    loss_fn = lambda p, b: X.loss_fn(p, cfg, b)  # noqa: E731
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # ------------------------- the Trainer, launches counted
    per_step = train_launches_per_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _cuda.reset_launch_counts()
    trainer = Trainer(step, params0, opt0,
                      checkpoint_manager=CheckpointManager(
                          os.path.join(TRAIN_DIR, "trainer"), keep=1),
                      ckpt_every=TRAIN_CKPT_EVERY)
    hist = trainer.run(batch_for_step(s) for s in range(steps))
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_path_launches("xdeepfm_train", launches, TRAIN_PATH,
                        {k: steps * n for k, n in per_step.items()})
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        fail(f"xdeepfm_train: a loss is not finite: {losses}")
    step_s = [h["time_s"] for h in hist]
    med = float(np.median(step_s[1:] if len(step_s) > 1 else step_s))
    flop = train_flops(cfg, batch)
    progress(f"xdeepfm_train: {steps} steps of B={batch}: first "
             f"{step_s[0]:.2f} s, median {med:.3f} s, "
             f"{batch / med:.0f} samples/s, {flop / med * 1e-12:.2f} "
             f"TFLOP/s, peak {peak / 2**30:.2f} GiB "
             f"({(peak - base) / 2**30:.2f} above the phase's start); "
             f"launches a step {per_step}; "
             f"losses {[round(x, 5) for x in losses]}")

    # ------------------------- restart runner, bit for bit
    t0 = time.perf_counter()
    runner = FaultTolerantRunner(
        step, params0, opt0, CheckpointManager(
            os.path.join(TRAIN_DIR, "runner"), keep=1),
        ckpt_every=TRAIN_CKPT_EVERY,
        failure_schedule={TRAIN_FAIL_STEP: RuntimeError(
            f"injected failure at step {TRAIN_FAIL_STEP}")})
    log = runner.run(None, max_steps=steps, batch_for_step=batch_for_step)
    runner_s = time.perf_counter() - t0
    a = flatten_with_paths({"params": trainer.params,
                            "opt_state": trainer.opt_state})
    b = flatten_with_paths({"params": runner.params,
                            "opt_state": runner.opt_state})
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if runner.restarts != 1 or runner.step != steps or differ:
        fail(f"xdeepfm_train: the restarted run ({runner.restarts} "
             f"restarts, step {runner.step}) differs from the "
             f"uninterrupted one in {differ}")
    replayed = [r["step"] for r in log if r["event"] == "step"]
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    del runner, a, b
    progress(f"xdeepfm_train: restarted at step {TRAIN_FAIL_STEP}, "
             f"replayed {replayed}; final state bit-identical "
             f"({runner_s:.1f} s)")

    # ------------------------- accumulation, compression, K11/K12 inputs
    b0 = batch_for_step(0)
    m0 = hist[0]
    _, _, m4 = make_train_step_for(cfg, accum_steps=4)(params0, opt0, b0)
    _, _, mc = make_train_step_for(cfg, compress_grads=True)(params0, opt0,
                                                             b0)
    calls = []
    with capture_cin_calls(calls):
        loss, grads = value_and_grad(loss_fn)(params0, b0)
    torch.cuda.synchronize()
    flat = flatten_with_paths(grads)
    gn = float(global_norm(grads))
    err2 = bound2 = 0.0
    ghat = {}
    for k, gk in flat.items():
        q, s = quantize_int8(gk)
        ghat[k] = q.to(torch.float32) * s
        err2 += float(((ghat[k] - gk) ** 2).sum())
        bound2 += int((gk != 0).sum()) * float(s) ** 2 / 4
    gn_hat = float(global_norm(ghat))
    del ghat, flat
    accum = {"loss": float(m4["loss"]), "grad_norm": float(m4["grad_norm"]),
             "loss_rel": abs(float(m4["loss"]) - m0["loss"]) / m0["loss"],
             "grad_norm_rel": abs(float(m4["grad_norm"]) - m0["grad_norm"])
             / m0["grad_norm"]}
    comp = {"loss": float(mc["loss"]), "grad_norm": float(mc["grad_norm"]),
            "grad_norm_uncompressed": gn, "grad_norm_dequantized": gn_hat,
            "quantization_err_norm": err2 ** 0.5,
            "quantization_err_bound": bound2 ** 0.5}
    if max(accum["loss_rel"], accum["grad_norm_rel"]) > TRAIN_LOSS_REL_TOL:
        fail(f"xdeepfm_train: accum_steps=4 differs from one batch: "
             f"{accum} against {m0}")
    if (comp["loss"] != m0["loss"] or abs(gn - m0["grad_norm"])
            > TRAIN_LOSS_REL_TOL * gn
            or abs(comp["grad_norm"] - gn_hat) > TRAIN_LOSS_REL_TOL * gn_hat
            or comp["quantization_err_norm"]
            > comp["quantization_err_bound"]):
        fail(f"xdeepfm_train: compress_grads=True: {comp} against {m0}")
    progress(f"xdeepfm_train: accum_steps=4 loss {accum['loss']:.7f} / "
             f"grad norm {accum['grad_norm']:.7f} against "
             f"{m0['loss']:.7f} / {m0['grad_norm']:.7f}; compressed grad "
             f"norm {comp['grad_norm']:.7f} (quantization error "
             f"{comp['quantization_err_norm']:.3e} <= "
             f"{comp['quantization_err_bound']:.3e})")
    del grads

    # ------------------------- where one step's device time goes
    prof = step_profile(lambda: step(params0, opt0, b0), per_step)

    # ------------------------- K12 and K11's backward calls, timed
    # (backward runs the layers last to first: dx1, then dx0's parts)
    roles = [(f"dx{x} layer {i}", i) for i in reversed(range(L))
             for x in ["1"] + ["0"] * len(kcin.cin_m_parts(
                 ([cfg.n_sparse] + list(cfg.cin_layers))[i],
                 kcin.cin_narrow(cfg.n_sparse, torch.float32)))]
    k11_calls = [c[1:] for c in calls if c[0] == "cin_layer"]
    k11_fwd_args, k11_args = k11_calls[:L], k11_calls[L:]
    k12_args = [c[1:] for c in calls if c[0] == "cin_weight_grad"][::-1]
    del calls, k11_calls
    if len(k11_fwd_args) != L or len(k11_args) != len(roles) or \
            len(k12_args) != L:
        fail(f"xdeepfm_train: a step made {len(k11_fwd_args)} K11 "
             f"forward, {len(k11_args)} K11 backward and {len(k12_args)} "
             f"K12 calls, expected {L}, {len(roles)} and {L}")
    with torch.no_grad():
        k11_fwd = [dict(train_kernel_record(
            "cin_layer", [t.detach() for t in args], TRAIN_ITERS,
            TRAIN_PLAIN_ITERS), call=f"forward layer {i}", layer=i)
            for i, args in enumerate(k11_fwd_args)]
        k11_back = [dict(train_kernel_record(
            "cin_layer", [t.detach() for t in args], TRAIN_ITERS,
            TRAIN_PLAIN_ITERS), call=role, layer=i)
            for args, (role, i) in zip(k11_args, roles)]
        k12 = [dict(train_kernel_record(
            "cin_weight_grad", [t.detach() for t in args], TRAIN_ITERS,
            TRAIN_PLAIN_ITERS), layer=i) for i, args in enumerate(k12_args)]
    del k11_fwd_args, k11_args, k12_args
    for name, recs in (("K11 forward", k11_fwd), ("K11 backward", k11_back),
                       ("K12", k12)):
        bad = [r for r in recs if r["max_abs_err"] > r["max_abs_tol"]
               or not r["deterministic"]]
        if bad:
            fail(f"xdeepfm_train: {name} differs from its plain version "
                 f"or from itself: {bad}")
    progress("xdeepfm_train: K12 " + ", ".join(
        f"{r['ms']:.2f} ms (H={r['H']})" for r in k12) + "; K11 "
        + ", ".join(f"{r['call']} {r['ms']:.2f} ms"
                    for r in k11_fwd + k11_back))
    if prof is not None:
        progress(f"xdeepfm_train: traced step: device busy "
                 f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
                 f"(idle {prof['idle_share']:.3f}); K11 wide "
                 f"{prof['k11_ms']:.1f} ms, narrow "
                 f"{prof['k11_narrow_ms']:.1f} ms, K12 "
                 f"{prof['k12_ms']:.1f} ms; "
                 f"launches in the trace {prof['launches_in_trace']} "
                 f"(complete: {prof['complete']})")

    # ------------------------- a whole step's gradient against plain
    bg = batch_for_step(0, grad_rows)
    _cuda.reset_launch_counts()
    l_k, g_k = value_and_grad(loss_fn)(params0, bg)
    _, g_k2 = value_and_grad(loss_fn)(params0, bg)
    torch.cuda.synchronize()
    grad_launches = dict(_cuda.LAUNCHES)
    with plain_on_card():
        l_p, g_p = value_and_grad(loss_fn)(params0, bg)
    torch.cuda.synchronize()
    fk, fk2, fp = (flatten_with_paths(t) for t in (g_k, g_k2, g_p))
    leaf_rel = {k: rel_err(fk[k], fp[k]) for k in fp
                if float(fp[k].abs().max()) > 0}
    grad_same = all(torch.equal(fk[k], fk2[k]) for k in fk)
    loss_rel = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    if max(leaf_rel.values()) > CIN_REL_TOL or not grad_same or \
            loss_rel > TRAIN_LOSS_REL_TOL:
        fail(f"xdeepfm_train: the step's gradient at {grad_rows} rows "
             f"differs from the plain path (loss {loss_rel}, leaves "
             f"{leaf_rel}, repeatable {grad_same})")
    if grad_launches != {k: (2 * per_step[k] if k in per_step else 0)
                         for k in grad_launches}:
        fail(f"xdeepfm_train: the gradient check launched "
             f"{grad_launches}")
    del g_k, g_k2, g_p, fk, fk2, fp
    progress(f"xdeepfm_train: a step's gradient at {grad_rows} rows "
             f"within {max(leaf_rel.values()):.2e} of the plain path's "
             f"leaves, repeatable")

    phase_s = time.perf_counter() - phase_t0
    k11_fwd_ms = sum(r["ms"] for r in k11_fwd)
    k11_ms = sum(r["ms"] for r in k11_back)
    k12_ms = sum(r["ms"] for r in k12)
    phase = {"phase": "xdeepfm_train", "config": dataclasses.asdict(cfg),
             "batch": batch, "steps": steps, "optimizer": dataclasses.asdict(
                 TRAIN_OPT),
             "losses": losses, "step_s": step_s, "first_step_s": step_s[0],
             "median_step_s": med, "samples_per_s": batch / med,
             "train_flop": flop, "tflop_per_s": flop / med * 1e-12,
             "launches": {k: launches[k] for k in TRAIN_PATH},
             "launches_per_step": per_step,
             "max_memory_allocated": peak, "allocated_before": base,
             "peak_above_before": peak - base,
             "ckpt_every": TRAIN_CKPT_EVERY,
             "restart": {"fail_step": TRAIN_FAIL_STEP,
                         "restarts": 1, "steps_run": replayed,
                         "runner_s": runner_s, "bit_identical": True},
             "accum_steps_4": accum, "compress_grads": comp,
             "grad_check": {"rows": grad_rows, "loss_rel": loss_rel,
                            "leaf_rel": leaf_rel, "repeatable": grad_same,
                            "launches": grad_launches},
             "step_profile": prof,
             "k11_forward_ms_per_step": k11_fwd_ms,
             "k11_backward_ms_per_step": k11_ms,
             "k12_ms_per_step": k12_ms,
             "k11_forward": k11_fwd, "k11_backward": k11_back,
             "k12_layers": k12,
             "phase_s": phase_s}
    main = k12[1 if L > 1 else 0]
    kern = {"name": "cin_weight_grad", "route": "cuda",
            "source": "src/repro_torch/csrc/cin_grad.cu",
            "replaces": ("none: the gradient of "
                         "src/repro/kernels/cin_fuse.py:39, which the "
                         "reference differentiates in XLA "
                         "(src/repro/models/xdeepfm.py:133)"),
            "launches": launches["cin_weight_grad"],
            **{k: main.get(k) for k in (
                "max_abs_err", "max_abs_tol", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_3xtf32_ms", "bound_fp32_ms", "library_ms",
                "library_rel_err", "deterministic", "splits")},
            "arithmetic": "3xtf32",
            "shape": {k: main[k] for k in ("B", "H", "M", "D", "K")},
            "train_layers": k12}
    # the narrow K11 kernel: its record at the largest narrow call (dx0
    # of the last 200-wide layer where there is one)
    narrow = [r for r in k11_back if r["kernel"] == "cin_layer_narrow"]
    if not narrow:
        return phase, [kern]
    big = max(narrow, key=lambda r: r["flop"])
    nkern = {"name": "cin_layer_narrow", "route": "cuda",
             "source": "src/repro_torch/csrc/cin_narrow.cu",
             "replaces": "src/repro/kernels/cin_fuse.py:39",
             "launches": launches["cin_layer_narrow"],
             **{k: big.get(k) for k in (
                 "max_abs_err", "max_abs_tol", "ms", "plain_ms", "bound_ms",
                 "bound_by", "bound_3xtf32_ms", "bound_fp32_ms",
                 "library_ms", "library_rel_err", "deterministic")},
             "arithmetic": "3xtf32", "call": big["call"],
             "shape": {k: big[k] for k in ("B", "H", "M", "D", "K")},
             "train_calls": narrow}
    return phase, [kern, nkern]


# ------------------------------------------------------------- the LM family
LM_ARCHS = ("llama3-8b", "qwen2-moe-a2.7b")
LM_PREFILL = 32768       # prefill_32k's sequence, one row (cut from 32)
LM_WARMUP = 4096         # the warm-up prefill, re-run for bit identity
LM_DECODE = {            # decode_32k, cut from 128 rows
    "llama3-8b": dict(batch=8, prompt=4096),
    "qwen2-moe-a2.7b": dict(batch=4, prompt=2048)}
LM_MAX_LEN = 32768       # decode_32k's cache length
LM_DECODE_STEPS = 32     # greedy steps over the whole cache
LM_CUT_LAYERS = 2        # depth of the float32 checks
LM_PARITY_TOKENS = 128   # card vs CPU forward, one row
LM_CUT_PROMPT = 48       # decode vs no-cache forward: prompt, then
LM_CUT_STEPS = 16        # steps (64 tokens: no MoE token overflows)
# The float32 checks hold the card to the per-position error of a
# forward whose attention rounds its operands to bf16 (q * scale, k, the
# probabilities, v, as the reference's does): a last-bit difference can
# round one of them the other way and move that position. Gated: the
# median position within LM_MEDIAN_TOL of max |ref|, every position
# within LM_JUMP_TOL, greedy tokens equal at LM_ARGMAX_SHARE of them.
LM_MEDIAN_TOL = 1e-3
LM_JUMP_TOL = 0.1
LM_ARGMAX_SHARE = 0.9


def position_errors(got, ref) -> dict:
    """Per-position max |got - ref| over the last axis, over max |ref|,
    and greedy agreement (float64 on the host)."""
    import torch
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    scale = float(ref.abs().max())
    per = ((got - ref).abs().amax(-1) / scale).flatten()
    return {"median": float(per.median()), "p90": float(per.quantile(0.9)),
            "max": float(per.max()), "max_abs_ref": scale,
            "argmax_equal": float((got.argmax(-1) == ref.argmax(-1))
                                  .double().mean())}


def check_positions(what: str, err: dict) -> None:
    if not (err["median"] <= LM_MEDIAN_TOL and err["max"] <= LM_JUMP_TOL
            and err["argmax_equal"] >= LM_ARGMAX_SHARE):
        fail(f"lm {what}: per-position error {err} beyond median "
             f"{LM_MEDIAN_TOL}, max {LM_JUMP_TOL}, argmax share "
             f"{LM_ARGMAX_SHARE}")


def lm_stream_tokens(vocab: int, batch: int, seq: int, device):
    import torch
    from repro_torch.data.lm import TokenStream
    toks = TokenStream(vocab, seq, batch, seed=0).next_batch()["tokens"]
    return torch.from_numpy(toks).to(device)


def lm_cut_checks(base, device) -> dict:
    """The float32 checks at `LM_CUT_LAYERS` layers of full width (seed
    0 on the card's generator, float32 masters): one row of
    `LM_PARITY_TOKENS` tokens through the card's forward and the CPU's
    (TF32 off), and `LM_CUT_STEPS` decode steps after an
    `LM_CUT_PROMPT`-token prompt against the card's no-cache forward."""
    import dataclasses
    import torch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(base, n_layers=LM_CUT_LAYERS,
                              compute_dtype="float32")
    model = T.LM(cfg, device=device, seed=0)
    params = C.param_tree(model)
    toks = lm_stream_tokens(cfg.vocab, 1, LM_PARITY_TOKENS, device)
    with torch.no_grad():
        card = T.forward(params, cfg, toks)[0]
        host = C.nest_params({k: v.cpu() for k, v in
                              C.flatten_params(params).items()})
        cpu = T.forward(host, cfg, toks.cpu())[0]
    del host
    parity = position_errors(card, cpu)
    check_positions(f"{cfg.name} card vs CPU forward", parity)
    prompt = lm_stream_tokens(cfg.vocab, 1, LM_CUT_PROMPT, device)
    dec, fed, cache, _, _ = lm_greedy_decode(
        params, cfg, prompt, device, steps=LM_CUT_STEPS,
        max_len=LM_CUT_PROMPT + LM_CUT_STEPS)
    del cache
    decode = lm_vs_forward(params, cfg, prompt, fed, dec)
    check_positions(f"{cfg.name} decode vs no-cache forward", decode)
    # bf16 compute on the same weights, cuBLAS's reduced-precision bf16
    # reductions allowed and not, each against the float32 forward
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    red = {}
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            allow
        with torch.no_grad():
            red[str(allow).lower()] = position_errors(
                T.forward(params, bf16, toks)[0], card)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return {"layers": LM_CUT_LAYERS, "card_vs_cpu": parity,
            "decode_vs_forward": decode,
            "bf16_vs_fp32_reduced_precision_reduction": red,
            "tol": {"median": LM_MEDIAN_TOL, "max": LM_JUMP_TOL,
                    "argmax_share": LM_ARGMAX_SHARE}}


class DropRecorder:
    """Wraps `transformer.moe_apply` while a run lasts: each MoE call
    also routes its tokens once more and keeps the count of (token,
    choice) pairs that `moe_ffn` drops (tensors; no sync in the run)."""

    def __init__(self):
        self.dropped, self.pairs = [], 0

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        self._orig = T.moe_apply

        def recorded(x, wp, cfg, mesh=None):
            _, _, idx = moe.route(x, wp["router"], cfg)
            keep = moe.dispatch_plan(idx, cfg)[3]
            self.dropped.append((~keep).sum())
            self.pairs += keep.numel()
            return self._orig(x, wp, cfg, mesh=mesh)

        T.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T
        T.moe_apply = self._orig

    def share(self) -> float:
        return float(sum(int(d) for d in self.dropped)) / max(self.pairs, 1)


def lm_prefill_run(model, cfg, device) -> dict:
    """prefill_32k cut to one row: the warm-up at `LM_WARMUP` tokens, run
    twice and held bit for bit, then `LM_PREFILL` tokens from
    `TokenStream`, timed, every logit finite."""
    import torch
    from repro_torch.configs.lm_common import lm_flops_prefill
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    params = C.param_tree(model)
    warm = lm_stream_tokens(cfg.vocab, 1, LM_WARMUP, device)
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(T.prefill_step(params, cfg, warm,
                                       return_logits=True))
    (n0, c0, l0), (n1, c1, l1) = outs
    if not (torch.equal(n0, n1) and torch.equal(l0, l1)
            and all(torch.equal(c0[k], c1[k]) for k in ("k", "v"))):
        fail(f"lm {cfg.name}: the warm-up prefill is not bit-identical on "
             "its re-run")
    del outs, c0, c1, l0, l1
    toks = lm_stream_tokens(cfg.vocab, 1, LM_PREFILL, device)
    _sync(device)
    base = torch.cuda.memory_allocated() if torch.device(
        device).type == "cuda" else 0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with DropRecorder() as rec, torch.no_grad():
        t0 = time.perf_counter()
        nxt, cache, logits = T.prefill_step(params, cfg, toks,
                                            return_logits=True)
        _sync(device)
        wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    if not finite:
        fail(f"lm {cfg.name} prefill_32k: a logit is not finite")
    flops = lm_flops_prefill(cfg, 1, LM_PREFILL)
    out = {"batch": 1, "seq": LM_PREFILL, "wall_s": wall,
           "tokens_per_s": LM_PREFILL / wall,
           "model_tflops": flops / wall / 1e12, "model_flop": flops,
           "logits_finite": finite, "warmup_bit_identical": True,
           "cache_gb": sum(c.numel() * c.element_size()
                           for c in cache.values()) / 1e9,
           "logits_gb": logits.numel() * logits.element_size() / 1e9}
    if torch.device(device).type == "cuda":
        out["peak_gb_above_start"] = (torch.cuda.max_memory_allocated()
                                      - base) / 1e9
    if cfg.moe:
        out["dropped_share"] = rec.share()
        out["moe_capL"] = max(max(int(LM_PREFILL * cfg.moe.top_k
                                      / cfg.moe.padded_experts
                                      * cfg.moe.capacity_factor), 4)
                              // cfg.moe.dispatch_shards, 4)
    return out


def lm_greedy_decode(params, cfg, toks, device, steps=LM_DECODE_STEPS,
                     max_len=LM_MAX_LEN, timed: bool = False):
    """Prefill ``toks`` [B, P] into a ``max_len`` cache, then ``steps``
    greedy steps over it. Returns (logits [B, steps, V], the fed tokens
    [B, steps], the cache, prefill s, step s)."""
    import torch
    from repro_torch.models import transformer as T
    P = toks.shape[1]
    t0 = time.perf_counter()
    with torch.no_grad():
        nxt, cache = T.prefill_step(params, cfg, toks, max_len=max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    fed, logits, step_s = [], [], []
    with torch.no_grad():
        for i in range(steps):
            fed.append(nxt)
            t0 = time.perf_counter()
            nxt, lg, cache = T.decode_step(params, cfg, cache, nxt, P + i)
            if timed:
                _sync(device)
            step_s.append(time.perf_counter() - t0)
            logits.append(lg)
    return (torch.stack(logits, 1), torch.stack(fed, 1), cache, prefill_s,
            step_s)


def lm_vs_forward(params, cfg, toks, fed, logits) -> dict:
    """Each row's no-cache forward over the prompt and the fed tokens,
    against the decode's logits at the same positions
    (`position_errors`)."""
    import torch
    from repro_torch.models import transformer as T
    P = toks.shape[1]
    seq = torch.cat([toks, fed], 1)
    with torch.no_grad():
        full = torch.cat([T.forward(params, cfg, seq[b:b + 1])[0][:, P:]
                          for b in range(len(seq))])
    return position_errors(logits, full)


def lm_decode_run(model, cfg, device) -> dict:
    """decode_32k cut to `LM_DECODE[arch]` rows: a `LM_MAX_LEN` cache
    filled by a prefill of the prompt, then `LM_DECODE_STEPS` greedy
    steps, each over the whole cache, timed one by one; one step traced;
    then each row's no-cache bf16 forward over the same tokens (printed).
    For an MoE also at a capacity without drops (a forward drops tokens
    at its capacity; a decode step's few tokens never overflow), and
    again with the router and output gate rounded to bf16 for decode too
    (the reference's decode routes with the float32 router, its forward
    with the bf16 one)."""
    import dataclasses
    import torch
    from repro_torch.configs.lm_common import lm_flops_decode
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    spec = LM_DECODE[cfg.name]
    B, P = spec["batch"], spec["prompt"]
    params = C.param_tree(model)
    toks = lm_stream_tokens(cfg.vocab, B, P, device)
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    base = torch.cuda.memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    logits, fed, cache, prefill_s, step_s = lm_greedy_decode(
        params, cfg, toks, device, timed=True)
    finite = bool(torch.isfinite(logits).all())
    if not finite:
        fail(f"lm {cfg.name} decode_32k: a logit is not finite")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9 if on_card \
        else None
    prof = None
    if on_card:
        last = fed[:, -1]
        with torch.no_grad():
            rows, wall = trace_second_call(
                lambda: T.decode_step(params, cfg, cache, last,
                                      P + LM_DECODE_STEPS - 1))
        busy = sum(ms for _, ms, _ in rows)
        prof = {"device_busy_ms": busy, "wall_ms": wall * 1e3,
                "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
                "top": [{"kernel": n[:120], "ms": ms, "count": c}
                        for n, ms, c in rows[:8]]} if rows else None
    del cache
    if on_card:
        torch.cuda.empty_cache()
    agree = {"": lm_vs_forward(params, cfg, toks, fed, logits)}
    if cfg.moe:
        # capacity Ep / K: cap = N, so no shard's expert can overflow
        roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.padded_experts
            / cfg.moe.top_k))
        agree["_no_drops"] = lm_vs_forward(params, roomy, toks, fed, logits)
        rounded = dict(params, layers={
            k: (v.to(torch.bfloat16).to(torch.float32)
                if k in T.FP32_LEAVES else v)
            for k, v in params["layers"].items()})
        lg_r, fed_r, cache, _, _ = lm_greedy_decode(rounded, roomy, toks,
                                                    device)
        del cache
        agree["_no_drops_bf16_router"] = lm_vs_forward(rounded, roomy, toks,
                                                       fed_r, lg_r)
    agree = {"vs_no_cache_forward_bf16" + tag: {
        "greedy_equal_share": e["argmax_equal"],
        "max_abs_dlogit_over_max_abs_logit": e["max"],
        "median": e["median"]} for tag, e in agree.items()}
    med = float(np.median(step_s))
    flops = lm_flops_decode(cfg, B, LM_MAX_LEN)
    kv = 2 * cfg.n_layers * B * LM_MAX_LEN * cfg.n_kv_heads * cfg.d_head * 2
    return {"batch": B, "prompt": P, "max_len": LM_MAX_LEN,
            "steps": LM_DECODE_STEPS, "prefill_s": prefill_s,
            "step_ms_median": med * 1e3, "step_ms_first": step_s[0] * 1e3,
            "step_ms_max": max(step_s) * 1e3,
            "tokens_per_s": B / med, "model_tflops": flops / med / 1e12,
            "model_flop_per_step": flops, "kv_cache_gb": kv / 1e9,
            "logits_finite": finite, "peak_gb_above_start": peak,
            "traced_step": prof, **agree}


def lm_phase(device, configs=None) -> dict:
    """Path 13: the LM family's serving path at full width. Per arch
    (`LM_ARCHS`, ``configs`` overriding `get_config()`): the float32
    checks at `LM_CUT_LAYERS` layers (`lm_cut_checks`), then a bf16
    served copy (router and shared output gate float32) from seed 0 on
    the card's generator: prefill_32k and decode_32k, each cut in
    batch. No kernel of the port runs (the reference's attention and
    experts are jnp ops, not Pallas kernels): every launch count must
    stay 0."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as T
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _sync(device)
    _cuda.reset_launch_counts()
    t_phase = time.perf_counter()
    out = {"phase": "lm", "runs": {}}
    for arch in LM_ARCHS:
        cfg = (configs or {}).get(arch) or get_arch(arch).get_config()
        t0 = time.perf_counter()
        cut = lm_cut_checks(cfg, device)
        cut["wall_s"] = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
        # the served copy: bf16 but for the float32 router / out gate,
        # cuBLAS's bf16 reductions in float32 (the reference's one rounding)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        t0 = time.perf_counter()
        model = T.LM(cfg, device=device, seed=0, dtype=torch.bfloat16)
        _sync(device)
        init_s = time.perf_counter() - t0
        weights_gb = sum(p.numel() * p.element_size()
                         for p in model.parameters()) / 1e9
        t0 = time.perf_counter()
        prefill = lm_prefill_run(model, cfg, device)
        prefill["run_wall_s"] = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        decode = lm_decode_run(model, cfg, device)
        decode["run_wall_s"] = time.perf_counter() - t0
        del model
        if on_card:
            torch.cuda.empty_cache()
        out["runs"][arch] = {
            "config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "weights_gb": weights_gb, "init_s": init_s,
            "cut_depth_fp32": cut, "prefill_32k": prefill,
            "decode_32k": decode,
            "reduced": [f"prefill_32k batch 32 -> 1",
                        f"decode_32k batch 128 -> "
                        f"{LM_DECODE[cfg.name]['batch']}, prompt "
                        f"{LM_DECODE[cfg.name]['prompt']} tokens + "
                        f"{LM_DECODE_STEPS} steps",
                        "random weights (seed 0)"]}
        progress(f"lm {arch}: prefill_32k {prefill['wall_s']:.2f} s "
                 f"({prefill['tokens_per_s']:.0f} tokens/s), decode_32k "
                 f"{decode['step_ms_median']:.2f} ms a step")
    _sync(device)
    launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if launched:
        fail(f"lm phase launched kernels of the port: {launched}")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------- the LM family on a mesh
LM_MESH_SHARDS = 4       # logical shards of card 0: ("data", "model") 1 x 4
LM_LONG = 524288         # long_500k's cache length (batch 1)
LM_LONG_LAYERS = 4       # depth of the one-card long_500k cut (of 32)
LM_MESH_STEPS = 4        # decode steps at S - 4 .. S - 1
LM_MESH_FP32_LAYERS = 2  # depth of the float32 checks
LM_MESH_TOL = 1e-4       # float32, sharded vs unsharded, of max |ref|
LM_EP_ROWS = 8           # qwen2-moe decode rows through expert parallelism
LM_EP_LEN = 4096         # their cache's length
LM_EP_STEPS = 2
GPIPE = dict(stages=4, microbatches=8, rows=512, d=4096)
GPIPE_TOL = 2e-4


def sync_all(devices) -> None:
    import torch
    for d in dict.fromkeys(devices):
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def lm_mesh(devices, axes=None):
    """A ("data", "model") mesh over ``devices`` (1 x n unless ``axes``
    says otherwise)."""
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(devices, axes=axes or {"data": 1,
                                                    "model": len(devices)})


def seeded_cache(cfg, batch: int, max_len: int, mesh, seed: int) -> dict:
    """`init_cache(..., mesh=)`'s sequence-sharded cache, each block
    filled with unit normals (bf16) from a generator on its device seeded
    ``seed`` + its shard index, in place of a prefill of ``max_len``
    tokens."""
    import torch
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, batch, max_len, mesh=mesh)
    for i, kv in enumerate(("k", "v")):
        for k, blk in enumerate(cache[kv]):
            gen = torch.Generator(blk.device).manual_seed(
                seed + 1000 * i + k)
            for layer in blk:            # a layer at a time: no fp32 copy
                layer.normal_(generator=gen)
    return cache


def decode_run(params, cfg, cache, first, positions, mesh=None,
               devices=None, feed=None) -> dict:
    """Greedy decode steps at ``positions`` from tokens ``first`` [B]
    (or, with ``feed`` [steps, B], those tokens each step), each step
    timed between syncs of ``devices``. Returns logits [steps, B, V]
    (float32), the tokens fed and produced, and the step seconds."""
    import torch
    from repro_torch.models import transformer as T
    devices = devices or [params["embed"].device]
    tok, fed, out, logits, step_s = first, [], [], [], []
    for i, pos in enumerate(positions):
        if feed is not None:
            tok = feed[i]
        fed.append(tok)
        sync_all(devices)
        t0 = time.perf_counter()
        with torch.no_grad():
            tok, lg, cache = T.decode_step(params, cfg, cache, tok, pos,
                                           mesh=mesh)
        sync_all(devices)
        step_s.append(time.perf_counter() - t0)
        logits.append(lg.float())
        out.append(tok)
    return {"logits": torch.stack(logits), "fed": torch.stack(fed),
            "tokens": torch.stack(out), "step_s": step_s}


def long_decode_bound(cfg, params, max_len: int, n_cards: int) -> dict:
    """A decode step's bytes bound over a cache split on ``n_cards``:
    the busiest card (card 0: the weights and its cache block) reads
    each once, at `launch.roofline.HBM_BW`."""
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.models import common as C
    w = sum(t.numel() * t.element_size()
            for t in C.flatten_params(params).values())
    kv = 2 * cfg.n_layers * max_len * cfg.n_kv_heads * cfg.d_head * 2
    card0 = w + kv / n_cards
    return {"weights_gb": w / 1e9, "kv_cache_gb": kv / 1e9,
            "card0_gb": card0 / 1e9, "bound_ms": card0 / HBM_BW * 1e3,
            "bound_by": "bytes"}


def long_cut_run(cfg, params, mesh, card, trace: bool = False,
                 max_len: int | None = None) -> dict:
    """``cfg`` decoding one row of a ``max_len``-long (default `LM_LONG`)
    seeded cache split over ``mesh`` and, beside it, the unsharded
    `decode_step` on ``card``'s own copy of the same cache
    (teacher-forced on the sharded run's tokens), at the last
    `LM_MESH_STEPS` positions. Returns both runs' step times, the per-step errors
    (`position_errors`), the sharded run's peak above its start on each
    card, and with ``trace`` one sharded step's device time
    (`trace_second_call`)."""
    import torch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    devs = mesh.physical_devices()
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, 1, seed=0)
                             .next_batch()["tokens"][:, 0]).to(card)
    max_len = max_len or LM_LONG
    positions = list(range(max_len - LM_MESH_STEPS, max_len))
    cache = seeded_cache(cfg, 1, max_len, mesh, seed=1)
    whole = {k: torch.cat([b.to(card) for b in v], 2)
             for k, v in cache.items()}
    sync_all(devs)
    base = {d: torch.cuda.memory_allocated(d) for d in devs}
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    sh = decode_run(params, cfg, cache, first, positions, mesh=mesh,
                    devices=devs)
    peak = {str(d): (torch.cuda.max_memory_allocated(d) - base[d]) / 1e9
            for d in devs}
    prof = None
    if trace:
        last = sh["fed"][-1]
        with torch.no_grad():
            rows, wall = trace_second_call(
                lambda: T.decode_step(params, cfg, cache, last,
                                      positions[-1], mesh=mesh))
        busy = sum(ms for _, ms, _ in rows)
        prof = {"device_busy_ms": busy, "wall_ms": wall * 1e3,
                "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
                "top": [{"kernel": n[:120], "ms": ms, "count": c}
                        for n, ms, c in rows[:6]]} if rows else None
    un = decode_run(params, cfg, whole, None, positions, devices=[card],
                    feed=sh["fed"])
    errs = [position_errors(a, b) for a, b in zip(sh["logits"],
                                                  un["logits"])]
    same = bool(torch.equal(sh["tokens"].cpu(), un["tokens"].cpu()))
    del cache, whole
    return {"layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
            "max_len": max_len, "shards": mesh.size,
            "cards": len(devs), "positions": positions,
            "sharded_step_ms": [t * 1e3 for t in sh["step_s"]],
            "unsharded_step_ms": [t * 1e3 for t in un["step_s"]],
            "sharded_step_ms_median": float(np.median(sh["step_s"])) * 1e3,
            "unsharded_step_ms_median": float(np.median(un["step_s"]))
            * 1e3,
            "peak_gb_above_start": peak, "errors": errs,
            "max_rel_err": max(e["max"] for e in errs),
            "greedy_equal": same, "traced_step": prof,
            **long_decode_bound(cfg, params, max_len, len(devs))}


def lm_long_checks(mesh, card) -> dict:
    """long_500k on llama3-8b at full width over ``mesh``: `LM_LONG_LAYERS`
    layers of a bf16 served copy against the unsharded decode (greedy
    tokens equal), then `LM_MESH_FP32_LAYERS` layers of float32 masters
    within `LM_MESH_TOL` of max |ref| with greedy tokens equal."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    base = get_arch("llama3-8b").get_config()
    out = {}
    for tag, layers, dtype in (("bf16", LM_LONG_LAYERS, torch.bfloat16),
                               ("fp32", LM_MESH_FP32_LAYERS, torch.float32)):
        cfg = dataclasses.replace(
            base, n_layers=layers,
            compute_dtype="bfloat16" if tag == "bf16" else "float32")
        model = T.LM(cfg, device=card, seed=0, dtype=dtype)
        rec = long_cut_run(cfg, C.param_tree(model), mesh, card,
                           trace=tag == "bf16")
        del model
        torch.cuda.empty_cache()
        if not rec["greedy_equal"]:
            fail(f"lm_mesh long_500k {tag}: sharded and unsharded greedy "
                 f"tokens differ ({rec['errors']})")
        if tag == "fp32" and rec["max_rel_err"] > LM_MESH_TOL:
            fail(f"lm_mesh long_500k fp32: sharded vs unsharded logits "
                 f"{rec['max_rel_err']} of max |ref| > {LM_MESH_TOL}")
        out[tag] = rec
    return out


def moe_ep_check(mesh, card, layers: int = LM_MESH_FP32_LAYERS) -> dict:
    """qwen2-moe-a2.7b at full width, ``layers`` layers of float32
    masters (seed 0 on the card's generator, copied to the host),
    `LM_EP_ROWS` rows decoding `LM_EP_STEPS` steps over a seeded
    `LM_EP_LEN`-long cache with expert parallelism over ``mesh``'s
    "model" axis, against the same steps on the CPU over as many CPU
    shards (fed the CPU's tokens; TF32 off), held per position
    (`check_positions`). The route must be `moe_ffn_replicated_ep`'s
    own: its slot planner runs and `moe_ffn` does not."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.models import common as C
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").get_config(),
                              n_layers=layers, compute_dtype="float32")
    model = T.LM(cfg, device=card, seed=0)
    params = C.param_tree(model)
    host = C.nest_params({k: v.cpu() for k, v in
                          C.flatten_params(params).items()})
    cpu_mesh = ServingMesh((torch.device("cpu"),) * mesh.size,
                           mesh.axis_names, mesh.shape)
    gen = torch.Generator().manual_seed(3)
    shape = (layers, LM_EP_ROWS, LM_EP_LEN, cfg.n_kv_heads, cfg.d_head)
    kv = {k: torch.randn(shape, generator=gen).to(torch.bfloat16)
          for k in ("k", "v")}
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, LM_EP_ROWS, seed=0)
                             .next_batch()["tokens"][:, 0])
    positions = list(range(LM_EP_LEN - LM_EP_STEPS, LM_EP_LEN))
    calls = {"ep_slots": 0, "moe_ffn": 0}
    real = {n: getattr(moe, n) for n in calls}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return fn

    for n in calls:
        setattr(moe, n, counted(n))
    try:
        cpu = decode_run(host, cfg, {k: v.clone() for k, v in kv.items()},
                         first, positions, mesh=cpu_mesh,
                         devices=[torch.device("cpu")])
        on_card = decode_run(params, cfg,
                             {k: v.to(card) for k, v in kv.items()}, None,
                             positions, mesh=mesh, devices=[card],
                             feed=cpu["fed"].to(card))
    finally:
        for n in calls:
            setattr(moe, n, real[n])
    del model, host
    torch.cuda.empty_cache()
    if calls["moe_ffn"] or not calls["ep_slots"]:
        fail(f"lm_mesh qwen2-moe: the expert-parallel route did not run "
             f"({calls})")
    err = position_errors(on_card["logits"], cpu["logits"])
    check_positions("lm_mesh qwen2-moe expert-parallel card vs CPU", err)
    return {"layers": layers, "rows": LM_EP_ROWS, "max_len": LM_EP_LEN,
            "steps": LM_EP_STEPS, "shards": mesh.size,
            "experts_per_shard": cfg.moe.padded_experts
            // mesh.axis_size("model"),
            "capacity_per_shard": moe.ep_capacity(LM_EP_ROWS, cfg.moe),
            "calls": calls, "card_vs_cpu": err,
            "card_step_ms": [t * 1e3 for t in on_card["step_s"]]}


def gpipe_check(devices, card) -> dict:
    """`gpipe_forward` over a "pod" mesh of ``devices`` (`GPIPE`: 4
    stages, 8 microbatches of [512, 4096], float32, tanh(x @ w)) against
    the stages applied in turn on ``card``, within `GPIPE_TOL` of max
    |ref|; both timed."""
    import torch
    from repro_torch.distributed.pipeline import (gpipe_forward,
                                                  pipeline_bubble_fraction)
    from repro_torch.launch.mesh import make_serving_mesh
    S, M, b, d = (GPIPE[k] for k in ("stages", "microbatches", "rows", "d"))
    gen = torch.Generator(card).manual_seed(5)
    w = torch.randn((S, d, d), generator=gen, device=card) * d ** -0.5
    x = torch.randn((M, b, d), generator=gen, device=card)
    mesh = make_serving_mesh(devices, axes={"pod": S})
    devs = mesh.physical_devices()

    def seq():
        y = x
        for s in range(S):
            y = torch.tanh(y @ w[s])
        return y

    times = {}
    for name, fn, on in (("pipeline", lambda: gpipe_forward(mesh, w, x),
                          devs), ("sequential", seq, [card])):
        fn()
        sync_all(on)
        t0 = time.perf_counter()
        y = fn()
        sync_all(on)
        times[name] = (time.perf_counter() - t0) * 1e3
        if name == "pipeline":
            got = y
        else:
            ref = y
    err = rel_err(got, ref)
    if err > GPIPE_TOL:
        fail(f"lm_mesh gpipe_forward: {err} of max |ref| > {GPIPE_TOL}")
    return {**GPIPE, "cards": len(devs), "rel_err": err, "tol": GPIPE_TOL,
            "pipeline_ms": times["pipeline"],
            "sequential_ms": times["sequential"],
            "bubble_fraction": pipeline_bubble_fraction(M, S)}


LM_SERVE_PROMPT = 2048   # the served path over the mesh: prompt tokens
LM_SERVE_STEPS = 16      # greedy decode steps after it (llama3-8b)
LM_SERVE_ROOM = 64       # cache positions past the prompt


def prefill_transients(cfg, rows: int, seq: int, model_shards: int,
                       q_chunk: int = 512) -> dict:
    """Bytes a prefill over parameters stored by their specs holds
    beside its blocks and its cache on the card of a data shard of
    ``rows`` rows (and, with logical shards, of every "model" shard),
    reckoned from the code: the largest of the embedding's gather, a
    layer's attention (its gathered leaves, the residual, q / k / v
    with their rope copies, one query chunk's float32 scores, softmax
    and bf16 probabilities, the chunks' outputs joined), a layer's
    experts (the tokens repeated into their slots, the slot buffer,
    gate / up / silu products in float32, the expert outputs, every
    "model" shard's partial) and the head (its leaf gathered, the last
    position's logits), plus the residual carried between them. The
    float32 norms, the rope halves and the bf16 copies of q are counted
    as if all alive at once: an upper reckoning, not a measurement."""
    b = 2 if cfg.compute_dtype == "bfloat16" else 4
    N, D = rows * seq, cfg.d_model
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    qc = min(q_chunk, seq)
    embed = 3 * N * D * b
    attn = ((2 * D * hq + 2 * D * hkv + 2 * D) * b + 3 * N * D * b
            + 3 * N * D * 4 + N * hq * (6 * b + 4) + 6 * N * hkv * b
            + rows * cfg.n_heads * qc * seq * (4 + 4 + 2)
            + 2 * N * hq * b)
    if cfg.moe:
        m = cfg.moe
        EL = m.padded_experts // model_shards
        cap = min(N, max(int(N * m.top_k / m.padded_experts
                             * m.capacity_factor), 8))
        Fe = m.d_ff_expert
        ffn = (2 * N * D * b + m.top_k * N * D * b
               + (EL + 1) * (cap + 1) * D * b + 4 * EL * cap * Fe * 4
               + EL * cap * Fe * b + EL * cap * D * (4 + b)
               + 4 * N * D * b + model_shards * N * D * b)
    else:
        ffn = 3 * D * cfg.d_ff * b + N * cfg.d_ff * (2 * b + 4) \
            + 2 * N * D * b
    head = D * cfg.vocab * b + rows * cfg.vocab * (b + 4) + 2 * rows * D * b
    carry = 2 * N * D * b
    parts = {"embed": embed, "attention": attn, "ffn": ffn, "head": head}
    return {**{k + "_gb": v / 1e9 for k, v in parts.items()},
            "carry_gb": carry / 1e9,
            "total_gb": (max(parts.values()) + carry) / 1e9}


def cache_bytes(cache) -> dict:
    """Bytes of a (sequence-sharded) cache on each device."""
    out: dict = {}
    for blocks in cache.values():
        for b in (blocks if isinstance(blocks, (list, tuple)) else [blocks]):
            out[str(b.device)] = out.get(str(b.device), 0) \
                + b.numel() * b.element_size()
    return out


def lm_serve_checks(mesh, card) -> dict:
    """The served path over parameters stored by their specs on
    ``mesh`` (`transformer.prefill_step` into `init_cache(..., mesh=)`'s
    sequence blocks, then `decode_step` from them), at full width:
    llama3-8b, `LM_MESH_FP32_LAYERS` layers of float32 masters, a
    `LM_SERVE_PROMPT`-token prompt into a cache `LM_SERVE_ROOM` longer,
    then `LM_SERVE_STEPS` greedy steps, against the unsharded
    `prefill_step` + `decode_step` on the same weights (teacher-forced
    on the mesh's tokens): next token and greedy tokens equal, logits
    within `LM_MESH_TOL` of max |ref|; then dbrx-132b, 2 bf16 layers,
    the same prompt and `LM_MESH_STEPS` steps: the next token is the
    argmax of `_forward_mesh`'s last position, and the card's peak above
    its blocks stays within the cache and `prefill_transients`."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    P, L = LM_SERVE_PROMPT, LM_SERVE_PROMPT + LM_SERVE_ROOM
    out = {}
    cfg = dataclasses.replace(get_arch("llama3-8b").get_config(),
                              n_layers=LM_MESH_FP32_LAYERS,
                              compute_dtype="float32")
    model = T.LM(cfg, device=card, seed=0)
    params = C.param_tree(model)
    placed = T.shard_params(params, cfg, mesh)
    toks = lm_stream_tokens(cfg.vocab, 1, P, card)
    positions = list(range(P, P + LM_SERVE_STEPS))
    runs = {}
    for name, p in (("mesh", placed), ("unsharded", params)):
        sync_all([card])
        t0 = time.perf_counter()
        with torch.no_grad():
            nxt, cache = T.prefill_step(p, cfg, toks, max_len=L)
        sync_all([card])
        prefill_s = time.perf_counter() - t0
        run = decode_run(p, cfg, cache, nxt, positions, devices=[card],
                         feed=runs["mesh"]["fed"] if runs else None)
        run.update(next=nxt, prefill_s=prefill_s, cache={
            k: torch.cat(v, 2) if isinstance(v, list) else v
            for k, v in cache.items()})
        runs[name] = run
        del cache
    sh, un = runs["mesh"], runs["unsharded"]
    errs = [position_errors(a, b) for a, b in zip(sh["logits"],
                                                  un["logits"])]
    worst = max(e["max"] for e in errs)
    rec = {"layers": cfg.n_layers, "compute_dtype": "float32",
           "prompt": P, "max_len": L, "steps": LM_SERVE_STEPS,
           "next_equal": bool(torch.equal(sh["next"], un["next"])),
           "greedy_equal": bool(torch.equal(sh["tokens"].cpu(),
                                            un["tokens"].cpu())),
           "prompt_cache_bit_equal": all(
               torch.equal(sh["cache"][k][:, :, :P], un["cache"][k][:, :, :P])
               for k in ("k", "v")),
           "max_rel_err": worst, "errors": errs,
           "mesh_prefill_s": sh["prefill_s"],
           "unsharded_prefill_s": un["prefill_s"],
           "mesh_step_ms_median": float(np.median(sh["step_s"])) * 1e3,
           "unsharded_step_ms_median": float(np.median(un["step_s"])) * 1e3}
    del runs, sh, un, model, params, placed
    torch.cuda.empty_cache()
    if not (rec["next_equal"] and rec["greedy_equal"]) \
            or worst > LM_MESH_TOL:
        fail(f"lm_mesh serve llama3-8b: mesh vs unsharded {worst} of max "
             f"|ref| (tol {LM_MESH_TOL}), next token equal "
             f"{rec['next_equal']}, greedy equal {rec['greedy_equal']}")
    out["llama3_8b_fp32"] = rec
    cfg = dataclasses.replace(get_arch("dbrx-132b").get_config(),
                              n_layers=LM_MESH_FP32_LAYERS)
    params = T.init_params(cfg, torch.Generator(card).manual_seed(0),
                           dtype=torch.bfloat16, mesh=mesh)
    toks = lm_stream_tokens(cfg.vocab, 1, P, card)
    sync_all([card])
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    t0 = time.perf_counter()
    with torch.no_grad():
        nxt, cache = T.prefill_step(params, cfg, toks, max_len=L)
    sync_all([card])
    prefill_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(card) - base) / 1e9
    held = sum(cache_bytes(cache).values()) / 1e9
    reckon = prefill_transients(cfg, 1, P, mesh.axis_size("model"))
    with torch.no_grad():
        logits, _ = T._forward_mesh(params, cfg, toks)
    last = torch.argmax(logits[0][:, -1, :], dim=-1).to(nxt.dtype)
    del logits
    run = decode_run(params, cfg, cache, nxt, list(range(P, P
                                                         + LM_MESH_STEPS)),
                     devices=[card])
    rec = {"layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
           "prompt": P, "max_len": L, "prefill_s": prefill_s,
           "next_equals_forward_argmax": bool(torch.equal(nxt, last)),
           "peak_gb_above_blocks": peak, "cache_gb": held,
           "reckoned_transients": reckon,
           "step_ms": [t * 1e3 for t in run["step_s"]],
           "logits_finite": bool(torch.isfinite(run["logits"]).all())}
    del params, cache, run
    torch.cuda.empty_cache()
    if not rec["next_equals_forward_argmax"]:
        fail("lm_mesh serve dbrx-132b: the prefill's next token is not the "
             "argmax of the forward's last position")
    if peak > held + reckon["total_gb"]:
        fail(f"lm_mesh serve dbrx-132b: peak {peak} GB above the blocks, "
             f"past the cache {held} GB and the reckoned transients "
             f"{reckon['total_gb']} GB")
    if not rec["logits_finite"]:
        fail("lm_mesh serve dbrx-132b: a decode logit is not finite")
    out["dbrx_132b_bf16"] = rec
    return out


def lm_mesh_phase(device) -> dict:
    """Path 15: the mesh-only parallel code on ``device``, as
    `LM_MESH_SHARDS` logical shards of one card: llama3-8b long_500k
    (`lm_long_checks`: 4 layers in bf16 and 2 in float32 at full width,
    S = 524,288, one row, the cache split over the shards, against the
    unsharded decode on a copy of the same cache), qwen2-moe-a2.7b's
    expert-parallel decode against the CPU (`moe_ep_check`), and
    `gpipe_forward` (`gpipe_check`), and the served path over parameters
    stored by their specs, prefill then decode (`lm_serve_checks`). No
    kernel of the port runs: every launch count must stay 0."""
    import torch
    from repro_torch.kernels import _cuda
    card = torch.device(device)
    if card.type == "cuda" and card.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.cuda.empty_cache()
    sync_all([card])
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    devices = [card] * LM_MESH_SHARDS
    out = {"phase": "lm_mesh", "shards": LM_MESH_SHARDS,
           "long_500k": lm_long_checks(lm_mesh(devices), card)}
    out["moe_ep"] = moe_ep_check(lm_mesh(devices), card)
    out["gpipe"] = gpipe_check(devices, card)
    t1 = time.perf_counter()
    out["serve"] = lm_serve_checks(lm_mesh(devices), card)
    out["serve"]["wall_s"] = time.perf_counter() - t1
    sync_all([card])
    launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if launched:
        fail(f"lm_mesh phase launched kernels of the port: {launched}")
    out["wall_s"] = time.perf_counter() - t0
    lb = out["long_500k"]["bf16"]
    out["decode_ms_per_step"] = lb["sharded_step_ms_median"]
    out["bound_ms"] = lb["bound_ms"]
    out["peak_gb"] = lb["peak_gb_above_start"]
    out["idle_share"] = (lb["traced_step"] or {}).get("idle_share")
    progress(f"lm_mesh: long_500k x {LM_LONG_LAYERS} layers "
             f"{out['decode_ms_per_step']:.2f} ms a step (unsharded "
             f"{lb['unsharded_step_ms_median']:.2f}; bound "
             f"{out['bound_ms']:.2f}), peak {out['peak_gb']} GB, idle "
             f"{out['idle_share']}; serve "
             f"{out['serve']['llama3_8b_fp32']['max_rel_err']} of max |ref|, "
             f"{out['serve']['wall_s']:.1f} s; phase {out['wall_s']:.1f} s")
    return out


# ------------------------------------- training over a mesh (logical shards)
LM_TRAIN_SHARDS = 4      # ("data", "model") 4 x 1 logical shards of card 0
LM_TRAIN_LAYERS = 2      # llama3-8b at full width: 1.49 B float32 masters
LM_TRAIN_ROWS = 4        # one row a shard
LM_TRAIN_SEQ = 1024
LM_TRAIN_STEPS = 3       # warm-up 1: step 0 moves only the moments
LM_TRAIN_TOL = 1e-5      # sharded vs unsharded, float32, of max |ref|
LM_DBRX_LAYERS = 2       # dbrx-132b at full width: 31 GB of float32
LM_DBRX_ROWS = 8
LM_DBRX_LEN = 32768      # decode_32k's cache
LM_DBRX_STEPS = 4


def device_rel_err(got, exp) -> float:
    """max |got - exp| / max |exp|, on the device (float32: a leaf of a
    full-width model is too big to copy to the host in float64)."""
    return float((got - exp).abs().max() / exp.abs().max())


def block_accounting(trees, mesh) -> dict:
    """Per shard, the bytes of the storages its blocks of ``trees``
    (parameter, moment trees of `Sharded` leaves) live in against the
    bytes of its blocks' regions: equal where no shard keeps more than
    its blocks (a view of a whole leaf would count the whole). Per
    device, the distinct blocks' bytes."""
    from repro_torch.launch.mesh import Sharded, leaf_bytes
    from repro_torch.models import common as C
    leaves = [v for t in trees for v in C.flatten_params(t).values()]
    if not all(isinstance(v, Sharded) for v in leaves):
        fail("a leaf of the sharded state is not stored by its spec")
    held, blocks = [0] * mesh.size, [0] * mesh.size
    for v in leaves:
        for k in range(mesh.size):
            held[k] += v[k].untyped_storage().nbytes()
            blocks[k] += math.prod(b - a for a, b in v.region(k)) \
                * v[k].element_size()
    per_dev = {str(d): sum(leaf_bytes(v, d) for v in leaves)
               for d in mesh.physical_devices()}
    return {"shard_gb": [h / 1e9 for h in held],
            "blocks_gb": [b / 1e9 for b in blocks],
            "equal": held == blocks, "device_gb": {
                k: b / 1e9 for k, b in per_dev.items()}}


def rows_loss(cfg, blocks: int, mesh=None):
    """The loss of whole parameters over a batch taken as ``blocks`` row
    blocks, each its own forward (the kernels see a data shard's
    shapes; ``mesh`` routes the experts, `transformer.forward`),
    combined as the sharded step combines its shards: the
    cross-entropy's global mean (`collectives.cross_entropy_blocks`)
    plus the blocks' mean balance loss."""
    from repro_torch.distributed.collectives import cross_entropy_blocks
    from repro_torch.models import transformer as T

    def loss(p, b):
        outs = [T.forward(p, cfg, t, mesh=mesh)
                for t in np.split(b["tokens"], blocks)]
        return cross_entropy_blocks([o[0] for o in outs],
                                      np.split(b["labels"], blocks)) \
            + sum(o[1] for o in outs) / blocks
    return loss


def train_steps(cfg, params, batch, steps: int, mesh, devices,
                keep=None, loss=None) -> dict:
    """``steps`` of `make_train_step` (AdamW, warm-up 1) from ``params``
    (stored by their specs over ``mesh``, or whole with ``mesh`` None)
    with ``loss`` (`transformer.loss_fn` by default), each timed between
    syncs of ``devices``: the losses, the first moment after the first
    step and the last parameters (joined, on ``keep``, shard 0's device
    by default), the state's accounting where sharded."""
    import torch
    from repro_torch.launch.mesh import Sharded, join_leaf
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import map_sharded

    def whole(tree):
        def one(x):
            x = join_leaf(x) if isinstance(x, Sharded) else x
            return x if keep is None else x.to(keep)
        return map_sharded(one, tree)

    ocfg = O.OptimizerConfig(warmup_steps=1)
    step = make_train_step(loss or (lambda p, b: T.loss_fn(p, cfg, b)), ocfg,
                           mesh=mesh)
    p, o = params, O.init_opt_state(ocfg, params)
    losses, secs, lrs, norms, m0 = [], [], [], [], None
    for i in range(steps):
        sync_all(devices)
        t0 = time.perf_counter()
        p, o, met = step(p, o, batch)
        losses.append(float(met["loss"]))
        sync_all(devices)
        secs.append(time.perf_counter() - t0)
        lrs.append(float(met["lr"]))
        norms.append(float(met["grad_norm"]))
        if i == 0:
            m0 = whole(o.m)
    out = {"losses": losses, "step_s": secs, "lr": lrs, "grad_norm": norms,
           "m0": m0}
    if mesh is not None:
        out["accounting"] = block_accounting([p, o.m, o.v], mesh)
    out["params"] = whole(p)
    del p, o
    return out


def compare_runs(got: dict, ref: dict, card) -> dict:
    """`train_steps` records against each other: the losses' relative
    error, each first-moment leaf's error of its max |ref|, and the last
    parameters' entries past `LM_TRAIN_TOL` of their leaf's max |ref|
    (Adam turns last-bit noise in a near-zero gradient into a whole
    step: each such entry is held within 2 lr a moving step)."""
    from repro_torch.models import common as C
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(got["losses"], ref["losses"]))
    gm = C.flatten_params(got["m0"])
    grad_err = {k: device_rel_err(gm[k].to(card), v.to(card))
                for k, v in C.flatten_params(ref["m0"]).items()}
    flips, worst, n = 0, 0.0, 0
    gp = C.flatten_params(got["params"])
    for k, v in C.flatten_params(ref["params"]).items():
        v = v.to(card)
        d = (gp[k].to(card) - v).abs()
        flips += int((d > LM_TRAIN_TOL * float(v.abs().max())).sum())
        worst = max(worst, float(d.max()))
        n += v.numel()
    moving = sum(1 for lr in ref["lr"] if lr > 0)
    return {"loss_rel_err": loss_err, "first_loss_rel_err":
            abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_rel_err": max(grad_err.values()), "grad_rel_err_by_leaf":
            grad_err, "flipped_entries": flips, "entries": n,
            "max_param_abs_diff": worst,
            "flip_bound": 2 * max(ref["lr"]) * moving}


def lm_train_check(mesh, card, rows=LM_TRAIN_ROWS, seq=LM_TRAIN_SEQ,
                   steps=LM_TRAIN_STEPS) -> dict:
    """llama3-8b at full width, `LM_TRAIN_LAYERS` layers of float32
    masters and compute: the sharded draw (`init_params(mesh=)`) against
    `shard_params` of the whole draw byte for byte; ``steps`` sharded
    steps over ``mesh`` (``rows`` x ``seq`` tokens, rows over "data"),
    then, with their memory freed, the same steps unsharded on ``card``
    over the same row blocks (`rows_loss`: each data shard's rows their
    own forward, so every product has the sharded run's shapes): every
    loss within `LM_TRAIN_TOL` relative, each leaf of the first moment
    after step 0 (the clipped gradient) within `LM_TRAIN_TOL` of its
    max |ref|, the parameters after the last step within it but for
    updates that went the other way (`compare_runs`); each shard's
    storage its blocks' bytes. Beside them, the unsharded step over the
    whole batch at once: its first loss within `LM_TRAIN_TOL`, its
    gradient reported (another batch shape picks other GEMM kernels,
    and at this init a last-bit change moves the gradient far); the
    whole batch's gradient is held in float64 (`lm_train_witness`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import data_shards
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("llama3-8b").get_config(),
                              n_layers=LM_TRAIN_LAYERS,
                              compute_dtype="float32")
    devs = mesh.physical_devices()
    batch = TokenStream(cfg.vocab, seq, rows, seed=0).next_batch()
    t0 = time.perf_counter()
    sharded = T.init_params(cfg, torch.Generator(card).manual_seed(0),
                            mesh=mesh)
    sync_all(devs)
    init_s = time.perf_counter() - t0
    params = T.init_params(cfg, torch.Generator(card).manual_seed(0))
    ref = C.flatten_params(T.shard_params(params, cfg, mesh))
    for path, leaf in C.flatten_params(sharded).items():
        if not all(torch.equal(a, b) for a, b in zip(leaf, ref[path])):
            fail(f"lm_train_mesh: the sharded draw of {path} differs from "
                 f"shard_params of the whole draw")
    del ref
    # the sharded run's results wait on the host: the unsharded runs
    # need the card (1.49 B parameters, their moments, two updates)
    host = torch.device("cpu")
    got = train_steps(cfg, sharded, batch, steps, mesh, devs, keep=host)
    del sharded
    torch.cuda.empty_cache()
    blocks = len(data_shards(mesh))
    same = train_steps(cfg, params, batch, steps, None, [card], keep=host,
                       loss=rows_loss(cfg, blocks))
    torch.cuda.empty_cache()
    whole = train_steps(cfg, params, batch, steps, None, [card])
    del params
    torch.cuda.empty_cache()
    rec = {"layers": cfg.n_layers, "rows": rows, "seq": seq,
           "steps": steps, "shards": mesh.size, "cards": len(devs),
           "mesh": dict(zip(mesh.axis_names, mesh.shape)),
           "params": cfg.param_count(), "sharded_init_s": init_s,
           "init_equal": True, "losses": got["losses"],
           "grad_norm": got["grad_norm"], "sharded_step_s": got["step_s"],
           "unsharded_step_s": same["step_s"],
           "accounting": got["accounting"], "tol": LM_TRAIN_TOL,
           "vs_unsharded_same_rows": compare_runs(got, same, card),
           "vs_unsharded_whole_batch": compare_runs(got, whole, card),
           "whole_batch_grad_norm": whole["grad_norm"]}
    del got, same, whole
    torch.cuda.empty_cache()
    c = rec["vs_unsharded_same_rows"]
    if c["loss_rel_err"] > LM_TRAIN_TOL or c["grad_rel_err"] > LM_TRAIN_TOL:
        fail(f"lm_train_mesh: sharded vs unsharded loss {c['loss_rel_err']}"
             f", gradient {c['grad_rel_err']} of max |ref| > "
             f"{LM_TRAIN_TOL}")
    if c["max_param_abs_diff"] > c["flip_bound"] * (1 + 1e-3):
        fail(f"lm_train_mesh: a parameter moved {c['max_param_abs_diff']} "
             f"from the unsharded step's, past {c['flip_bound']}")
    if rec["vs_unsharded_whole_batch"]["first_loss_rel_err"] > LM_TRAIN_TOL:
        fail(f"lm_train_mesh: the first loss is "
             f"{rec['vs_unsharded_whole_batch']['first_loss_rel_err']} "
             f"from the whole batch's")
    if not rec["accounting"]["equal"]:
        fail(f"lm_train_mesh: a shard holds more than its blocks "
             f"({rec['accounting']})")
    return rec


LM_MOE_TRAIN_ROWS, LM_MOE_TRAIN_SEQ = 8, 64   # 2 data shards of 4 rows


def moe_train_check(card) -> dict:
    """qwen2-moe-a2.7b's smoke config (float32, ``remat="full"``) over
    ("data", "model") 2 x 2 logical shards of the card: each MoE layer
    one `remat.recompute` region over the shards (counted: one a layer a
    step); `LM_TRAIN_STEPS` sharded steps against the unsharded steps
    over the same row blocks, each block's experts routed over a 1 x 2
    mesh of the card as a data shard's are (`rows_loss`), at
    `lm_train_check`'s bars (`compare_runs`). (`moe_ffn` over a block
    routes, drops and balances the same, but adds the router's float32
    gradient in another order, which the attention's bf16 operands
    amplify to ~3e-4 of a leaf.)"""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").smoke_config(),
                              compute_dtype="float32", remat="full")
    mesh = lm_mesh([card] * 4, axes={"data": 2, "model": 2})
    batch = TokenStream(cfg.vocab, LM_MOE_TRAIN_SEQ, LM_MOE_TRAIN_ROWS,
                        seed=0).next_batch()
    params = T.init_params(cfg, torch.Generator(card).manual_seed(0))
    regions = []
    recompute = T.recompute
    T.recompute = lambda *a: regions.append(1) or recompute(*a)
    try:
        got = train_steps(cfg, T.shard_params(params, cfg, mesh), batch,
                          LM_TRAIN_STEPS, mesh, [card])
    finally:
        T.recompute = recompute
    same = train_steps(cfg, params, batch, LM_TRAIN_STEPS, None, [card],
                       loss=rows_loss(cfg, 2, lm_mesh([card] * 2)))
    c = compare_runs(got, same, card)
    rec = {"config": cfg.name, "mesh": {"data": 2, "model": 2},
           "rows": LM_MOE_TRAIN_ROWS, "seq": LM_MOE_TRAIN_SEQ,
           "steps": LM_TRAIN_STEPS, "recomputed_regions": len(regions),
           "losses": got["losses"], "sharded_step_s": got["step_s"],
           "unsharded_step_s": same["step_s"], "tol": LM_TRAIN_TOL,
           "vs_unsharded_same_rows": {k: v for k, v in c.items()
                                      if k != "grad_rel_err_by_leaf"}}
    if len(regions) != cfg.n_layers * LM_TRAIN_STEPS:
        fail(f"lm_train_mesh: {len(regions)} MoE regions recomputed, not "
             f"{cfg.n_layers} a step")
    if c["loss_rel_err"] > LM_TRAIN_TOL or c["grad_rel_err"] > LM_TRAIN_TOL:
        fail(f"lm_train_mesh: qwen2-moe sharded vs unsharded loss "
             f"{c['loss_rel_err']}, gradient {c['grad_rel_err']} of max "
             f"|ref| > {LM_TRAIN_TOL}")
    if c["max_param_abs_diff"] > c["flip_bound"] * (1 + 1e-3):
        fail(f"lm_train_mesh: a qwen2-moe parameter moved "
             f"{c['max_param_abs_diff']} from the unsharded step's, past "
             f"{c['flip_bound']}")
    return rec


def _joined_grads(grads) -> dict:
    """A gradient tree's leaves by path, each `Sharded` one joined on its
    first block's device, one leaf at a time."""
    from repro_torch.launch.mesh import Sharded, join_leaf
    from repro_torch.models import common as C
    flat = C.flatten_params(grads)
    del grads
    for path in list(flat):
        if isinstance(flat[path], Sharded):
            flat[path] = join_leaf(flat[path])
    return flat


def _grad_errs(got: dict, ref: dict) -> dict:
    return {k: device_rel_err(got[k].to(v.dtype), v) for k, v in ref.items()}


def lm_train_witness(mesh, card, rows=LM_TRAIN_ROWS, seq=LM_TRAIN_SEQ,
                     cfg=None) -> dict:
    """Whether the gap between the sharded and the whole-batch gradient
    (`lm_train_check`'s ``vs_unsharded_whole_batch``) is rounding or a
    fault of the row split. At ``cfg`` (llama3-8b, `LM_TRAIN_LAYERS`
    layers of full width by default), the first step's raw gradient of
    `transformer.loss_fn` over ``rows`` x ``seq`` tokens: whole on
    ``card`` and stored by spec over ``mesh`` (rows over "data"), in
    float32 and in float64 (the same parameters, widened), and in
    float32 whole at parameters nudged one ulp up. Each leaf's error of
    its max |ref|: the row split against the whole batch in float32 and
    in float64, the one-ulp nudge against the whole batch, and each
    float32 run against its float64 run. Where the row split is sound,
    the float64 pair agrees far closer than the float32 pair, and a
    last bit alone moves the float32 gradient about as far. Fails
    where the float64 row split's gradient or loss is past
    `LM_TRAIN_TOL` of the whole batch's."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import split_rows
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import map_sharded
    c32 = cfg or dataclasses.replace(get_arch("llama3-8b").get_config(),
                                     n_layers=LM_TRAIN_LAYERS)
    c32 = dataclasses.replace(c32, compute_dtype="float32")
    c64 = dataclasses.replace(c32, compute_dtype="float64")
    batch = TokenStream(c32.vocab, seq, rows, seed=0).next_batch()
    split = {k: split_rows(v, mesh) for k, v in batch.items()}

    def grads(c, p, stored):
        fn = value_and_grad(lambda q, b: T.loss_fn(q, c, b))
        loss, g = (fn(T.shard_params(p, c, mesh), split) if stored
                   else fn(p, batch))
        return float(loss), _joined_grads(g)

    t0 = time.perf_counter()
    params = T.init_params(c32, torch.Generator(card).manual_seed(0))
    l_w32, g_w32 = grads(c32, params, False)
    l_m32, g_m32 = grads(c32, params, True)
    rec = {"layers": c32.n_layers, "rows": rows, "seq": seq,
           "shards": mesh.size,
           "mesh": dict(zip(mesh.axis_names, mesh.shape)),
           "f32_mesh_vs_whole": _grad_errs(g_m32, g_w32)}
    nudged = map_sharded(lambda x: torch.nextafter(
        x, torch.full_like(x, math.inf)), params)
    l_n32, g_n32 = grads(c32, nudged, False)
    rec["f32_nudged_vs_whole"] = _grad_errs(g_n32, g_w32)
    del nudged, g_n32
    wide = map_sharded(lambda x: x.to(torch.float64), params)
    del params
    torch.cuda.empty_cache()
    l_w64, g_w64 = grads(c64, wide, False)
    rec["f32_whole_vs_f64_whole"] = _grad_errs(g_w32, g_w64)
    del g_w32
    torch.cuda.empty_cache()
    l_m64, g_m64 = grads(c64, wide, True)
    rec["f32_mesh_vs_f64_mesh"] = _grad_errs(g_m32, g_m64)
    rec["f64_mesh_vs_whole"] = _grad_errs(g_m64, g_w64)
    del wide, g_m32, g_w64, g_m64
    torch.cuda.empty_cache()
    rec["losses"] = {"f32_whole": l_w32, "f32_mesh": l_m32,
                     "f32_nudged": l_n32, "f64_whole": l_w64,
                     "f64_mesh": l_m64}
    rec["worst"] = {k: max(rec[k].values()) for k in (
        "f32_mesh_vs_whole", "f32_nudged_vs_whole", "f32_whole_vs_f64_whole",
        "f32_mesh_vs_f64_mesh", "f64_mesh_vs_whole")}
    rec["f64_loss_rel_err"] = abs(l_m64 - l_w64) / abs(l_w64)
    rec["wall_s"] = time.perf_counter() - t0
    if rec["worst"]["f64_mesh_vs_whole"] > LM_TRAIN_TOL \
            or rec["f64_loss_rel_err"] > LM_TRAIN_TOL:
        fail(f"lm_train_mesh witness: in float64 the row split's gradient "
             f"is {rec['worst']['f64_mesh_vs_whole']} of max |ref| from "
             f"the whole batch's, its loss {rec['f64_loss_rel_err']} "
             f"(tol {LM_TRAIN_TOL})")
    return rec


def dbrx_decode_check(mesh, card, rows=LM_DBRX_ROWS, max_len=LM_DBRX_LEN,
                      steps=LM_DBRX_STEPS) -> dict:
    """dbrx-132b at full width, `LM_DBRX_LAYERS` layers of float32: the
    per-shard draw over ``mesh`` against `shard_params` of the whole
    draw byte for byte (then freed); ``steps`` greedy decode steps at
    ``rows`` rows over a seeded ``max_len``-long cache split along its
    sequence, the leaves stored by their specs as views of the whole
    copy, against the whole leaves over a copy of the same cache blocks
    (teacher-forced on the stored run's tokens; the mesh routes the
    experts in both, so only the storage differs), within
    `LM_TRAIN_TOL` of max |ref| with greedy tokens equal. Records the
    phase's peak on each card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("dbrx-132b").get_config(),
                              n_layers=LM_DBRX_LAYERS,
                              compute_dtype="float32")
    devs = mesh.physical_devices()
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    params = T.init_params(cfg, torch.Generator(card).manual_seed(0))
    t0 = time.perf_counter()
    drawn = T.init_params(cfg, torch.Generator(card).manual_seed(0),
                          mesh=mesh)
    sync_all(devs)
    init_s = time.perf_counter() - t0
    placed = T.shard_params(params, cfg, mesh)
    ref = C.flatten_params(placed)
    for path, leaf in C.flatten_params(drawn).items():
        if not all(torch.equal(a, b) for a, b in zip(leaf, ref[path])):
            fail(f"lm_train_mesh dbrx: the sharded draw of {path} differs "
                 f"from shard_params of the whole draw")
    del drawn, ref
    torch.cuda.empty_cache()
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, rows, seed=0)
                             .next_batch()["tokens"][:, 0]).to(card)
    positions = list(range(max_len - steps, max_len))
    cache = seeded_cache(cfg, rows, max_len, mesh, seed=5)
    twin = {k: [b.clone() for b in v] for k, v in cache.items()}
    sh = decode_run(placed, cfg, cache, first, positions, devices=devs)
    un = decode_run(params, cfg, twin, None, positions, mesh=mesh,
                    devices=[card], feed=sh["fed"])
    errs = [position_errors(a, b) for a, b in zip(sh["logits"],
                                                  un["logits"])]
    same = bool(torch.equal(sh["tokens"].cpu(), un["tokens"].cpu()))
    peak = {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in devs}
    del cache, twin, placed, params
    torch.cuda.empty_cache()
    worst = max(e["max"] for e in errs)
    if not same or worst > LM_TRAIN_TOL:
        fail(f"lm_train_mesh dbrx decode: stored by spec vs whole "
             f"{worst} of max |ref| (tol {LM_TRAIN_TOL}), greedy equal "
             f"{same}")
    return {"layers": cfg.n_layers, "rows": rows, "max_len": max_len,
            "steps": steps, "shards": mesh.size,
            "mesh": dict(zip(mesh.axis_names, mesh.shape)),
            "sharded_init_s": init_s, "init_equal": True,
            "max_rel_err": worst, "greedy_equal": same,
            "stored_step_ms": [t * 1e3 for t in sh["step_s"]],
            "whole_step_ms": [t * 1e3 for t in un["step_s"]],
            "peak_gb": peak}


LM_CKPT_DIR = os.path.join(ROOT, "build", "lm_mesh_ckpt")
LM_CKPT_ROWS, LM_CKPT_SEQ = 4, 64


def ckpt_remesh_check(card) -> dict:
    """A sharded train state's checkpoint on the card, in the
    reference's file: llama3-8b's smoke config (float32; the full-width
    state of `lm_train_check` is 17.9 GB, past what the phase can write
    and read back in its time) over ("data", "model") 2 x 2 logical
    shards, one AdamW step, saved by `CheckpointManager` (each leaf one
    global array) and restored onto 2 x 1: every global leaf equal to
    the saved one, and the restarted step on 2 shards equal, bit for
    bit, to the uninterrupted step there (the same state stored onto
    the 2 shards in memory, `shard_leaf` of each joined leaf)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import Sharded, join_leaf, shard_leaf
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import flatten_global, map_sharded
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              compute_dtype="float32")
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=0)
    meshes = {n: lm_mesh([card] * n, axes={"data": 2, "model": n // 2})
              for n in (4, 2)}
    steps = {n: make_train_step(lambda p, b: T.loss_fn(p, cfg, b), ocfg,
                                mesh=m) for n, m in meshes.items()}
    stream = TokenStream(cfg.vocab, LM_CKPT_SEQ, LM_CKPT_ROWS, seed=0)
    batches = [stream.next_batch() for _ in range(2)]
    params = T.init_params(cfg, torch.Generator(card).manual_seed(0),
                           mesh=meshes[4])
    params, opt, _ = steps[4](params, O.init_opt_state(ocfg, params),
                              batches[0])
    state = {"params": params, "opt_state": opt}
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
    cm = CheckpointManager(LM_CKPT_DIR)
    sync_all([card])
    t0 = time.perf_counter()
    cm.save(1, state)
    save_s = time.perf_counter() - t0
    like = T.init_params(cfg, torch.Generator(card).manual_seed(1),
                         mesh=meshes[2])
    t0 = time.perf_counter()
    got, _ = cm.restore({"params": like,
                         "opt_state": O.init_opt_state(ocfg, like)})
    sync_all([card])
    restore_s = time.perf_counter() - t0
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)

    def whole(tree):
        return {k: join_leaf(v) if isinstance(v, Sharded) else v
                for k, v in flatten_global(tree).items()}

    saved = whole(state)
    same = all(torch.equal(v, saved[k]) for k, v in whole(got).items())
    on2 = map_sharded(lambda x: shard_leaf(join_leaf(x), x.spec,
                                           meshes[2])
                      if isinstance(x, Sharded) else x.clone(), state)
    ran = [steps[2](t["params"], t["opt_state"], batches[1])
           for t in (got, on2)]
    (pa, oa, ma), (pb, ob, mb) = ran
    a, b = whole({"p": pa, "o": oa}), whole({"p": pb, "o": ob})
    restart_equal = all(torch.equal(v, b[k]) for k, v in a.items()) \
        and float(ma["loss"]) == float(mb["loss"])
    mesh_of = flatten_global(got["params"])["layers/wq"].mesh
    rec = {"config": cfg.name, "saved_shards": meshes[4].size,
           "restored_shards": mesh_of.size, "leaves": len(saved),
           "state_mb": sum(v.numel() * v.element_size()
                           for v in saved.values()) / 1e6,
           "save_s": save_s, "restore_s": restore_s,
           "restored_equal": same, "restart_step_bit_equal": restart_equal}
    if not (same and restart_equal):
        fail(f"lm_train_mesh checkpoint: restored onto 2 shards {rec}")
    return rec


def lm_train_mesh_phase(device) -> dict:
    """Path 16: training over a mesh on ``device``, as logical shards of
    one card: llama3-8b's sharded train step against the unsharded one
    (`lm_train_check`, ("data", "model") 4 x 1), its gradient against
    the whole batch's in float64 (`lm_train_witness`), dbrx-132b's decode
    over leaves stored by their specs (`dbrx_decode_check`, 1 x 4),
    qwen2-moe's sharded train step through the MoE layer's recompute
    over the shards (`moe_train_check`, 2 x 2) and the sharded
    checkpoint (`ckpt_remesh_check`). No kernel of the port runs: every
    launch count must stay 0."""
    import torch
    from repro_torch.kernels import _cuda
    card = torch.device(device)
    if card.type == "cuda" and card.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    sync_all([card])
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    devices = [card] * LM_TRAIN_SHARDS
    train_mesh = lm_mesh(devices, axes={"data": LM_TRAIN_SHARDS, "model": 1})
    out = {"phase": "lm_train_mesh", "shards": LM_TRAIN_SHARDS,
           "llama_train": lm_train_check(train_mesh, card)}
    out["witness"] = lm_train_witness(train_mesh, card)
    out["dbrx_decode"] = dbrx_decode_check(lm_mesh(devices), card)
    t1 = time.perf_counter()
    out["moe_train"] = moe_train_check(card)
    out["moe_train"]["wall_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["checkpoint"] = ckpt_remesh_check(card)
    out["checkpoint"]["wall_s"] = time.perf_counter() - t1
    sync_all([card])
    launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if launched:
        fail(f"lm_train_mesh phase launched kernels of the port: "
             f"{launched}")
    out["wall_s"] = time.perf_counter() - t0
    lt, dd, w = out["llama_train"], out["dbrx_decode"], out["witness"]
    c = lt["vs_unsharded_same_rows"]
    progress(f"lm_train_mesh: llama3-8b x {lt['layers']} sharded steps "
             f"{[round(s, 3) for s in lt['sharded_step_s']]} s (unsharded "
             f"{[round(s, 3) for s in lt['unsharded_step_s']]}), loss "
             f"{c['loss_rel_err']}, gradient {c['grad_rel_err']}, "
             f"{c['flipped_entries']} flipped of {c['entries']}; witness "
             f"{w['worst']}; dbrx "
             f"decode {dd['max_rel_err']}, peak {dd['peak_gb']} GB; "
             f"qwen2-moe {out['moe_train']}; "
             f"checkpoint 4 -> 2 shards {out['checkpoint']}; phase "
             f"{out['wall_s']:.1f} s")
    return out


# ------------------------------------------- the graph family over a mesh
GNN_MESH_SHARDS = 4      # ("data",) 4 logical shards of card 0
GNN_MESH_NODES = 1 << 19          # past BIG_GRAPH: the block recompute runs
GNN_MESH_RAW_EDGES = 1 << 22      # E = 2^23 once symmetrised
GNN_MESH_CHUNK = 1 << 19          # EDGE_CHUNK: 4 chunks a shard
# check A's graph: the unsharded float32 step at 2^19 x 2^23 does not fit
# the card (GatedGCN's recomputed block of 4 layers keeps ~94 GB of edge
# tensors), so it runs 2^17 x 2^21 with BIG_GRAPH and EDGE_CHUNK lowered
# to keep the same path (blocks of 4 layers recomputed, 4 chunks a shard)
GNN_MESH_EXACT = dict(nodes=1 << 17, raw_edges=1 << 20, big_graph=1 << 16,
                      chunk=1 << 17)
GNN_MESH_SHAPE = "ogb_products"   # the cell whose widths and specs it takes
GNN_MESH_LOSS_TOL = 1e-5          # float32, sharded vs unsharded, relative
GNN_MESH_GRAD_TOL = 1e-4          # each leaf, of its max |ref| (GRAD_TOL)
# archs whose check A runs in float64: PNA's std aggregate cancels, and at
# full width its own float32 gradient misses its float64 one by more than
# the whole leaf (3.1 x max |ref| of enc_w on a 2,048-node CPU rehearsal)
GNN_MESH_FLOAT64 = ("pna",)


@contextlib.contextmanager
def gnn_mesh_sizes(big_graph: int, chunk: int):
    """`models.gnn.BIG_GRAPH` and `EDGE_CHUNK` set for a block of runs."""
    from repro_torch.models import gnn as G
    old = G.BIG_GRAPH, G.EDGE_CHUNK
    G.BIG_GRAPH, G.EDGE_CHUNK = big_graph, chunk
    try:
        yield
    finally:
        G.BIG_GRAPH, G.EDGE_CHUNK = old


def gnn_mesh_graph(d_feat: int, n_classes: int, seed: int = 0,
                   nodes: int = GNN_MESH_NODES,
                   raw_edges: int = GNN_MESH_RAW_EDGES) -> dict:
    """The mesh phase's graph, numpy from ``seed``: ``raw_edges`` uniform
    random edges among ``nodes`` nodes, symmetrised; normal features,
    labels among the classes, NequIP's positions, one energy."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nodes, raw_edges).astype(np.int32)
    v = rng.integers(0, nodes, raw_edges).astype(np.int32)
    return {"feat": rng.standard_normal((nodes, d_feat)).astype(np.float32),
            "edges_src": np.concatenate([u, v]),
            "edges_dst": np.concatenate([v, u]),
            "labels": rng.integers(0, n_classes, nodes).astype(np.int32),
            "pos": (rng.standard_normal((nodes, 3)) * 2).astype(np.float32),
            "energy": rng.standard_normal(1).astype(np.float32)}


def gnn_mesh_loss(cfg, n_edges: int, shape: str = GNN_MESH_SHAPE):
    """The loss ``cfg`` trains at ``shape``, over a graph of ``n_edges``
    edges: a GNN's cross-entropy; NequIP's force loss on molecule, else
    its energy MSE in the reference's edge chunks of ``n_edges``."""
    import torch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.launch.mesh import Sharded
    from repro_torch.models import gnn as G
    from repro_torch.models import nequip as NQ
    ng = GC.n_graphs_of(cfg, shape)
    if not isinstance(cfg, NQ.NequIPConfig):
        return lambda p, b: G.loss_fn(p, cfg, b, n_graphs=ng)
    if GC.nequip_force_weight(shape):
        return lambda p, b: NQ.loss_fn(p, cfg, b, n_graphs=ng,
                                       force_weight=GC.nequip_force_weight(
                                           shape))
    chunk = GC.nequip_edge_chunk(n_edges)

    def loss(p, b):
        e = NQ.energy_fn(p, cfg, b, n_graphs=ng, edge_chunk=chunk)
        t = b["energy"]
        t = t[0] if isinstance(t, Sharded) else torch.as_tensor(t)
        return torch.mean((e - t.to(e.device)) ** 2)
    return loss


def gnn_mesh_step(cfg, batch, mesh, card, reps: int = 1,
                  shape: str = GNN_MESH_SHAPE) -> dict:
    """``reps`` runs of one AdamW step (`TRAIN_OPT`) of ``cfg`` from the
    same seeded init drawn on ``card``: over ``mesh`` (parameters and
    moments stored by `gnn_common.shard_params`, ``batch`` placed by the
    cell's `batch_specs` once, before the clock) or whole on ``card``
    with ``mesh`` None. Each run timed between syncs of the mesh's
    cards; the loss, the first moment after the step (a tenth of the
    clipped gradient) joined on ``card``, and each card's peak above the
    run's start."""
    import torch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.launch.mesh import Sharded, join_leaf, place_batch
    from repro_torch.models import common as C
    from repro_torch.models import gnn as G
    from repro_torch.models import nequip as NQ
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import map_sharded
    mod = NQ if isinstance(cfg, NQ.NequIPConfig) else G
    cards = [card] if mesh is None else list(mesh.physical_devices())
    params = mod.init_params(cfg, torch.Generator(card).manual_seed(0))
    if mesh is None:
        placed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(card)
                  for k, v in batch.items()}
        step = make_train_step(gnn_mesh_loss(cfg, len(batch["edges_src"]),
                                             shape), GC.TRAIN_OPT)
    else:
        params = GC.shard_params(params, cfg, mesh)
        specs = GC.batch_specs(cfg, shape, "pod" in mesh.axis_names)
        placed = place_batch(batch, mesh, specs)
        step = make_train_step(gnn_mesh_loss(cfg, len(batch["edges_src"]),
                                             shape), GC.TRAIN_OPT, mesh=mesh,
                               batch_specs=specs, one_thread=True)
    sync_all(cards)
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    runs = []
    for _ in range(reps):
        opt = O.init_opt_state(GC.TRAIN_OPT, params)
        sync_all(cards)
        t0 = time.perf_counter()
        _, o, met = step(params, opt, placed)
        loss = float(met["loss"])
        sync_all(cards)
        secs = time.perf_counter() - t0
        m = C.flatten_params(map_sharded(
            lambda x: (join_leaf(x) if isinstance(x, Sharded) else x).to(
                card), o.m))
        runs.append({"loss": loss, "step_s": secs, "m": m})
        del o, met
    peak = {str(c): (torch.cuda.max_memory_allocated(c) - base[c]) / 1e9
            for c in cards}
    del params, placed, step
    torch.cuda.empty_cache()
    return {"runs": runs, "peak_gb": peak}


def gnn_mesh_compare(got: dict, ref: dict) -> dict:
    """A run's loss and first moments against another's: the loss's
    relative error, each leaf's error of its max |ref|."""
    errs = {k: device_rel_err(got["m"][k].float(), v.float())
            for k, v in ref["m"].items()}
    return {"loss_rel_err": abs(got["loss"] - ref["loss"]) / abs(
        ref["loss"]), "grad_rel_err": max(errs.values()),
        "grad_rel_err_by_leaf": errs}


def gnn_mesh_bit_equal(a: dict, b: dict) -> bool:
    import torch
    return a["loss"] == b["loss"] and all(
        torch.equal(a["m"][k], b["m"][k]) for k in a["m"])


def gnn_mesh_arch(arch: str, cfg, exact, batch, mesh, card) -> dict:
    """One arch: check A on ``exact`` (`GNN_MESH_EXACT`'s graph) in
    float32 (float64 for the archs of `GNN_MESH_FLOAT64`), the sharded
    step run twice (bit for bit) against the unsharded step (the loss
    within `GNN_MESH_LOSS_TOL`, every leaf of the clipped gradient within
    `GNN_MESH_GRAD_TOL` of its max |ref|); check B on ``batch`` (the
    2^19-node graph) in the cell's own dtype (bf16), one step sharded and
    one unsharded, timed, each card's peak, their loss gap reported (no
    bound)."""
    import dataclasses
    dt = "float64" if arch in GNN_MESH_FLOAT64 else "float32"
    f32 = dataclasses.replace(cfg, compute_dtype=dt)
    with gnn_mesh_sizes(GNN_MESH_EXACT["big_graph"], GNN_MESH_EXACT["chunk"]):
        sh = gnn_mesh_step(f32, exact, mesh, card, reps=2)
        un = gnn_mesh_step(f32, exact, None, card)
    a, b = sh["runs"]
    cmp = gnn_mesh_compare(a, un["runs"][0])
    rec = {"check_a": {"dtype": dt, "nodes": len(exact["feat"]),
                       "edges": len(exact["edges_src"]),
                       "sharded_step_ms": [r["step_s"] * 1e3 for r in
                                           sh["runs"]],
                       "unsharded_step_ms": un["runs"][0]["step_s"] * 1e3,
                       "loss": a["loss"], "unsharded_loss": un["runs"][0][
                           "loss"], "rerun_bit_equal": gnn_mesh_bit_equal(
                               a, b), **cmp}}
    del sh, un, a, b
    if not rec["check_a"]["rerun_bit_equal"]:
        fail(f"gnn_mesh {arch}: the sharded step's re-run differs")
    if cmp["loss_rel_err"] > GNN_MESH_LOSS_TOL or \
            cmp["grad_rel_err"] > GNN_MESH_GRAD_TOL:
        fail(f"gnn_mesh {arch}: sharded vs unsharded ({dt}) loss "
             f"{cmp['loss_rel_err']}, gradient {cmp['grad_rel_err']} of "
             f"max |ref| (tols {GNN_MESH_LOSS_TOL}, {GNN_MESH_GRAD_TOL})")
    from repro_torch.models import gnn as G
    with gnn_mesh_sizes(G.BIG_GRAPH, GNN_MESH_CHUNK):
        sh = gnn_mesh_step(cfg, batch, mesh, card)
        un = gnn_mesh_step(cfg, batch, None, card)
    s0, u0 = sh["runs"][0], un["runs"][0]
    rec["check_b"] = {"dtype": cfg.compute_dtype,
                      "nodes": len(batch["feat"]),
                      "edges": len(batch["edges_src"]),
                      "sharded_step_ms": s0["step_s"] * 1e3,
                      "unsharded_step_ms": u0["step_s"] * 1e3,
                      "sharded_peak_gb": sh["peak_gb"],
                      "unsharded_peak_gb": un["peak_gb"],
                      "loss": s0["loss"], "unsharded_loss": u0["loss"],
                      "loss_rel_gap": abs(s0["loss"] - u0["loss"])
                      / abs(u0["loss"])}
    return rec


def gnn_mesh_phase(device, nodes: int = GNN_MESH_NODES,
                   raw_edges: int = GNN_MESH_RAW_EDGES) -> dict:
    """Path 17: the graph family over a mesh of `GNN_MESH_SHARDS` logical
    shards of the card, ("data",): GIN, PNA and GatedGCN at
    `get_config()` width and depth, sized by `shape_config(cfg,
    "ogb_products")`, each by `gnn_mesh_arch`: check A on
    `GNN_MESH_EXACT`'s graph, check B on the ``nodes`` x 2 ``raw_edges``
    one (both past `BIG_GRAPH`, as each sets it, so the layers recompute
    in blocks of 4 and each shard's edges run in 4 chunks); NequIP at
    `get_config()` on the molecule shape with forces, sharded (twice, bit
    for bit) against unsharded at the same bars. No kernel of the port
    runs: every launch count must stay 0."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_serving_mesh
    card = torch.device(device)
    if card.type == "cuda" and card.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    sync_all([card])
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    mesh = make_serving_mesh([card] * GNN_MESH_SHARDS)
    base = GC.shape_config(get_arch("gin-tu").get_config(), GNN_MESH_SHAPE)
    exact = gnn_mesh_graph(base.d_feat, base.n_classes, seed=1,
                           nodes=GNN_MESH_EXACT["nodes"],
                           raw_edges=GNN_MESH_EXACT["raw_edges"])
    batch = gnn_mesh_graph(base.d_feat, base.n_classes, nodes=nodes,
                           raw_edges=raw_edges)
    out = {"phase": "gnn_mesh", "shards": GNN_MESH_SHARDS,
           "nodes": nodes, "edges": 2 * raw_edges,
           "edge_chunk": GNN_MESH_CHUNK, "check_a_sizes": GNN_MESH_EXACT,
           "archs": {}}
    for arch in GNN_ARCHS:
        cfg = GC.shape_config(get_arch(arch).get_config(), GNN_MESH_SHAPE)
        out["archs"][arch] = r = gnn_mesh_arch(arch, cfg, exact, batch,
                                               mesh, card)
        a, b = r["check_a"], r["check_b"]
        progress(f"gnn_mesh {arch}: check A ({a['dtype']}) loss "
                 f"{a['loss_rel_err']:.2e}, gradient {a['grad_rel_err']:.2e};"
                 f" bf16 sharded {b['sharded_step_ms']:.1f} ms (unsharded "
                 f"{b['unsharded_step_ms']:.1f}), peak {b['sharded_peak_gb']}"
                 f" GB (unsharded {b['unsharded_peak_gb']})")
    del batch, exact
    nq = GC.shape_config(get_arch("nequip").get_config(), "molecule")
    mol = GC.cell_batch("molecule", seed=1)
    sh = gnn_mesh_step(nq, mol, mesh, card, reps=2, shape="molecule")
    un = gnn_mesh_step(nq, mol, None, card, shape="molecule")
    a, b = sh["runs"]
    cmp = gnn_mesh_compare(a, un["runs"][0])
    out["archs"]["nequip"] = {
        "shape": "molecule", "force_weight": GC.nequip_force_weight(
            "molecule"), "sharded_step_ms": [r["step_s"] * 1e3
                                             for r in sh["runs"]],
        "unsharded_step_ms": un["runs"][0]["step_s"] * 1e3,
        "rerun_bit_equal": gnn_mesh_bit_equal(a, b),
        "sharded_peak_gb": sh["peak_gb"], **cmp}
    if not out["archs"]["nequip"]["rerun_bit_equal"]:
        fail("gnn_mesh nequip: the sharded step's re-run differs")
    if cmp["loss_rel_err"] > GNN_MESH_LOSS_TOL or \
            cmp["grad_rel_err"] > GNN_MESH_GRAD_TOL:
        fail(f"gnn_mesh nequip: sharded vs unsharded loss "
             f"{cmp['loss_rel_err']}, gradient {cmp['grad_rel_err']}")
    sync_all([card])
    launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if launched:
        fail(f"gnn_mesh phase launched kernels of the port: {launched}")
    out["launches"] = {}
    out["wall_s"] = time.perf_counter() - t0
    progress(f"gnn_mesh: phase {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------ the examples
EXAMPLES = {  # example -> the kernels its card run must launch
    "quickstart_torch": ("wcsd_query_ragged",),
    "serve_wcsd_torch": ("wcsd_query_gathered", "wcsd_query_ragged",
                         "wcsd_profile_ragged"),
    "wcsd_features_gnn_torch": ("wcsd_query_ragged",),
    "train_lm_torch": (),
}


def examples_phase() -> dict:
    """Path 11: the port's examples (`examples/quickstart_torch.py`,
    `examples/serve_wcsd_torch.py`, `examples/wcsd_features_gnn_torch.py`)
    at their default sizes on the card, their own asserts included (the
    quickstart: the index against the constrained-BFS oracle and the
    engine's K1 batch against it; the serving example: the padded, CSR
    and 8-shard legs equal, BFS spot checks, the profile staircases and
    their memo; the GNN example: the GIN with WC-INDEX encodings, from
    K1, beats the bare features). Their printout goes to stderr; each
    one's launches are counted."""
    import importlib.util
    import torch
    from repro_torch.kernels import _cuda
    out = {"phase": "examples"}
    for name, path in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = mod.main([])
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        check_path_launches(f"examples: {name}", launches, path, {})
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "launches": {k: launches[k] for k in path}}
        if name == "quickstart_torch":
            out[name]["counts"] = res
        if name == "wcsd_features_gnn_torch":
            out[name].update(acc_base=res["acc_base"],
                             acc_wcsd=res["acc_wcsd"])
        if name == "train_lm_torch":
            steps = [r for r in res if r["event"] == "step"]
            out[name].update(
                steps=len(steps), first_loss=steps[0]["loss"],
                last_loss=steps[-1]["loss"],
                failures=sum(r["event"] == "failure" for r in res),
                median_step_s=float(np.median([r["time_s"]
                                               for r in steps])))
        progress(f"examples: {name} passed on the card in "
                 f"{out[name]['wall_s']:.1f} s, launches "
                 f"{out[name]['launches']}")
    return out


# -------------------------------------------------------- the dry run
DRYRUN_COUNTED = (("llama3-8b", "decode_32k"), ("qwen2-moe-a2.7b",
                                                "decode_32k"),
                  ("gin-tu", "full_graph_sm"), ("nequip", "molecule"),
                  ("xdeepfm", "train_batch"), ("wcsd-serve", "serve_1m"))
DRYRUN_EXECUTED = (("wcsd-serve", "serve_1m"), ("wcsd-serve", "profile_1m"),
                   ("xdeepfm", "serve_p99"), ("xdeepfm", "retrieval_cand"))
DRYRUN_PATH = ("wcsd_query_gathered", "cin_layer")
K9_SLICE = 4096          # serve_1m queries held against K9's plain version


def dryrun_cells() -> dict:
    """Every cell of the dry-run matrix on both production meshes: the
    40 of `configs.all_cells` and wcsd-serve's 2, by (arch, shape,
    multi_pod)."""
    from repro_torch.configs import all_cells, get_arch
    cells = {}
    for mp in (False, True):
        for arch, shape, cell in all_cells(mp):
            cells[(arch, shape, mp)] = cell
        w = get_arch("wcsd-serve")
        for shape in w.SHAPES:
            cells[("wcsd-serve", shape, mp)] = w.make_cell(shape,
                                                           multi_pod=mp)
    return cells


def k9_slice_check(result: dict):
    """``check`` for serve_1m's executed warm-up step: its first
    `K9_SLICE` answers equal K9's plain version on the same gathered rows,
    exactly; the share of those queries whose rows pass K9's merge check
    and the share answered (a hub meet) go into ``result``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wcsd_query as kwq

    def check(args, out):
        hub, dist, wlev, count, s, t, w = args
        sl = slice(0, K9_SLICE)
        hs, ds, ht, dt = kops.gather_padded_rows(hub, dist, wlev, count,
                                                 s[sl], t[sl], w[sl])
        exp = kops._to_inf_dist(kwq.wcsd_query_gathered_plain(hs, ds, ht,
                                                              dt))
        if not torch.equal(out[sl], exp):
            bad = int((out[sl] != exp).sum())
            fail(f"dryrun serve_1m: {bad} of {K9_SLICE} answers differ "
                 "from K9's plain version")
        ok = (mergeable_rows(hs, ds >= kwq.DEV_INF)
              & mergeable_rows(ht, dt >= kwq.DEV_INF))
        result.update(k9_slice=K9_SLICE, k9_slice_equal_plain=True,
                      merge_share=float(ok.float().mean()),
                      answered_share=float((exp < INF_DIST).float().mean()))

    return check


def dryrun_phase(device) -> dict:
    """Path 14: the dry-run matrix (`launch.dryrun`) on the card's terms.
    Builds all 84 cells and their per-card argument and output bytes on
    both production meshes; counts one cell a family at full width on
    meta tensors (`DRYRUN_COUNTED`); runs on the card at their global
    sizes the cells of `DRYRUN_EXECUTED` (serve_1m through K9: 2^20
    queries against a 2^20 x 256 store whose rows hold sorted hubs and
    their pads at the end; profile_1m through the plain profile join;
    serve_p99 and retrieval_cand through K11), each one warm-up step and
    the median of 3 timed, beside its counted peak and one-card bound;
    and holds `K9_SLICE` of serve_1m's answers against K9's plain
    version. K9 and K11 must launch; the counts launch nothing."""
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.launch import dryrun as D
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cells = dryrun_cells()
    per_card = {f"{a}|{s}|{D.mesh_name(mp)}": D.cell_bytes(c, mp)
                for (a, s, mp), c in cells.items()}
    build_s = time.perf_counter() - t_phase
    counted = {}
    for arch, shape in DRYRUN_COUNTED + DRYRUN_EXECUTED:
        if (arch, shape) in counted:
            continue
        counts, _ = D.count_cell(cells[(arch, shape, False)])
        counted[(arch, shape)] = counts
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    executed = {}
    for arch, shape in DRYRUN_EXECUTED:
        extra = {}
        ex = D.execute_cell(cells[(arch, shape, False)],
                            counted[(arch, shape)], device,
                            check=(k9_slice_check(extra)
                                   if shape == "serve_1m" else None))
        if "step_ms" not in ex:
            fail(f"dryrun {arch} {shape} did not run: {ex}")
        executed[f"{arch}|{shape}"] = {**ex, **extra}
        progress(f"dryrun {arch} {shape}: {ex['step_ms']:.3f} ms a step, "
                 f"peak {ex['peak_bytes']} B (counted "
                 f"{ex['counted_peak_bytes']} B), roofline share "
                 f"{ex['roofline_share']}")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    check_path_launches("dryrun", launches, DRYRUN_PATH, {})
    if not executed["wcsd-serve|serve_1m"].get("k9_slice_equal_plain"):
        fail("dryrun serve_1m: the K9 slice was not checked")
    keep = ("flops", "hbm_bytes", "moved_bytes", "int_ops", "peak_bytes",
            "argument_bytes", "ops", "count_s")
    return {"phase": "dryrun", "cells": len(cells), "build_s": build_s,
            "per_card_bytes": per_card,
            "counted": {f"{a}|{s}": {**{k: c[k] for k in keep},
                                     "kernels": c["kernels"]}
                        for (a, s), c in counted.items()},
            "executed": executed,
            "launches": {k: launches[k] for k in DRYRUN_PATH},
            "wall_s": time.perf_counter() - t_phase}


# ------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.xdeepfm_arch import get_config
    from repro_torch.core.generators import random_queries, scale_free
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as kops

    dev = DEVICE
    progress("building kernels")
    tool = toolchain()
    progress(f"kernels built in {tool['kernel_build_s']:.1f} s")

    # ---------------------------------------------- the main path, once
    V = 1 << LOG2_V
    B = BATCH
    t0 = time.perf_counter()
    g = scale_free(V, m=4, num_levels=5, seed=0)
    graph_s = time.perf_counter() - t0
    s, t, wl = random_queries(g, 1 << LOG2_QUERIES, seed=1)
    ps, pt, _ = random_queries(g, 1 << LOG2_PROFILES, seed=2)
    flushes_epoch, flushes_cont = [], []
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    progress(f"main path: build V={V}")
    with Capture(kops, target_batch=(-(-V // B)) // 2) as cap:
        t0 = time.perf_counter()
        idx, stats = build_wc_index_batched_packed(g, batch_size=B,
                                                   device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    after_build = dict(_cuda.LAUNCHES)
    steps = cap.step_seconds()
    floor_s = cap.floor_bound_s()
    progress(f"built in {build_s:.1f} s: {stats}")
    srv_e, out_e, prof_e, wall_e = serve_epoch(idx, (s, t, wl), (ps, pt),
                                               MAX_BATCH, flushes_epoch, dev)
    after_epoch = dict(_cuda.LAUNCHES)
    progress(f"epoch serving {wall_e:.1f} s")
    srv_c, out_c, prof_c, wall_c = serve_continuous(idx, (s, t, wl),
                                                    (ps, pt), MAX_BATCH,
                                                    flushes_cont, dev)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    progress(f"continuous serving {wall_c:.1f} s; launches {launches}")
    check_path_launches("main path", launches, MAIN_PATH, {})

    # ------------------------------------------------- build phase checks
    ar = srv_e.engine.arena
    build = {"phase": "build", "V": V, "edges": g.num_edges,
             "max_degree": int(g.degree().max()), "levels": g.num_levels,
             "batch_size": B, "graph_s": graph_s, "build_s": build_s,
             "rounds": stats["rounds"], "raw_entries": stats["raw_entries"],
             "entries": stats["entries"],
             "entries_per_vertex": stats["entries"] / V,
             "dominated_removed": stats["dominated_removed"],
             "partial_index_cap": stats["partial_index_cap"],
             "finalize_s": stats["finalize_s"],
             "round_loop_s": build_s - stats["finalize_s"],
             "step_device_s": steps, "k3_build_bound_floor_s": floor_s,
             "arena_tiles": ar.num_tiles, "arena_bytes": ar.memory_bytes(),
             "max_tiles_per_row": int(ar.tile_cnt.max()),
             "launches": {k: after_build[k] for k in
                          ("wc_prune_emit_batched", "wc_relax_batched")}}
    gc = scale_free(CHECK_V, m=4, num_levels=5, seed=0)
    t0 = time.perf_counter()
    ic, _ = build_wc_index_batched_packed(gc, batch_size=B, device=dev)
    check_gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ih, _ = build_wc_index_batched_packed(gc, batch_size=B, device="cpu")
    check_cpu_s = time.perf_counter() - t0
    for name in ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
                 "bucket_of", "slot_of"):
        a, b = getattr(ic.labels, name), getattr(ih.labels, name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"{CHECK_V}-vertex build: card and CPU differ in "
                 f"PackedLabels.{name}")
    build.update(check_v=CHECK_V, check_identical=True,
                 check_card_s=check_gpu_s, check_cpu_s=check_cpu_s)
    progress(f"{CHECK_V}-vertex card/CPU builds identical")

    # ------------------------------------------------- serve phase checks
    serve = {"phase": "serve", "max_batch": MAX_BATCH,
             "queries": len(s), "profile_queries": len(ps)}
    for name, srv, out, prof, wall, log, base in (
            ("epoch", srv_e, out_e, prof_e, wall_e, flushes_epoch,
             after_build),
            ("continuous", srv_c, out_c, prof_c, wall_c, flushes_cont,
             after_epoch)):
        nq = sum(1 for r in log if r[0] == "query")
        np_ = sum(1 for r in log if r[0] == "profile")
        k1 = (after_epoch if name == "epoch" else launches)[
            "wcsd_query_ragged"] - base["wcsd_query_ragged"]
        k2 = (after_epoch if name == "epoch" else launches)[
            "wcsd_profile_ragged"] - base["wcsd_profile_ragged"]
        if (k1, k2) != (nq, np_):
            fail(f"{name}: {nq} query + {np_} profile flushes made "
                 f"{k1} K1 + {k2} K2 launches (expected one each)")
        bad = 0
        for rec in log:
            if not np.array_equal(rec[4].wait(), plain_flush(srv.engine,
                                                             rec)):
                bad += 1
        if bad:
            fail(f"{name}: {bad} flushes differ from the plain path")
        lat = srv.latency_summary()
        serve[name] = {
            "wall_s": wall, "requests_per_s": (len(s) + len(ps)) / wall,
            "server_flushes": srv.stats.batches,
            "query_dispatches": nq, "profile_dispatches": np_,
            "k1_launches": k1, "k2_launches": k2,
            "launches_per_dispatch": (k1 + k2) / max(nq + np_, 1),
            "dispatch_s": srv.stats.dispatch_time_s,
            "drain_wait_s": srv.stats.drain_wait_s,
            "p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
            "memo_hits": srv.stats.memo_hits,
            "max_batch_seen": srv.stats.max_batch,
            "opportunistic_flushes": srv.stats.opportunistic_flushes,
            "deadline_flushes": srv.stats.deadline_flushes,
            "flushes_equal_plain": True}
    if not (np.array_equal(out_e, out_c) and np.array_equal(prof_e, prof_c)):
        fail("epoch and continuous serving answers differ")
    if not np.array_equal(prof_e[np.arange(len(ps)), 0],
                          srv_e.engine.query(ps, pt, np.zeros(len(ps),
                                                              np.int32))):
        fail("profile level 0 differs from the scalar query")
    check_bfs_sample(srv_e.engine, g, 3, "main path")
    progress("served answers equal the plain path and the host BFS")
    serve["bfs_pairs"] = int(BFS_PAIRS)
    serve["bfs_levels"] = g.num_levels + 1
    serve["bfs_equal"] = True

    # --------------------- compressed fallback, compressed, bucket-pair
    qrec = next(r for r in flushes_epoch if r[0] == "query")
    prec = next(r for r in flushes_epoch if r[0] == "profile")
    fallback = compressed_fallback_phase(idx, srv_e.engine, qrec, prec, dev)
    progress(f"V={V} compressed arena: {fallback['overflow_tiles']} of "
             f"{fallback['tiles']} tiles overflow")
    comp_serve, comp_kernels, comp_world = compressed_serve_phase(dev)
    ladder = ladder_phase(*comp_world, dev)
    sharded = sharded_phase(idx, (s, t, wl), (ps, pt), out_e, prof_e,
                            comp_world, dev)
    del comp_world
    bp_serve, bp_kernels = bucket_pair_phase(idx, (s, t, wl), (ps, pt),
                                             out_e, prof_e, dev)

    # ------------------------------------ padded layout, single-root BFS
    pad_serve, pad_kernels = padded_serve_phase(idx, (s, t, wl), (ps, pt),
                                                out_e, prof_e, dev)
    relax, relax_kernels = frontier_relax_phase(g, dev)

    # ------------------ the GNN family: K1 encodings, GIN/PNA/GatedGCN
    gnn = gnn_phase(g, idx, dev)

    # ------------------------- the dynamic index: updates, WAL, chaos
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    dyn = dynamic_phase(dev)

    # ------------------------------------------ xDeepFM serving (K11)
    xdf, xdf_kernels = xdeepfm_phase(get_config(), dev)

    # ----------------------------------- xDeepFM training (K11, K12)
    train, train_kernels = xdeepfm_train_phase(get_config(), dev)
    k11 = xdf_kernels[0]
    k11.update(serve_launches=k11["launches"],
               train_launches=train["launches"]["cin_layer"],
               train_backward_calls=[r for r in train["k11_backward"]
                                     if r["kernel"] == "cin_layer"])
    k11["launches"] += train["launches"]["cin_layer"]

    # --------------------------------------------------- the examples
    examples = examples_phase()

    # ------------------- the LM family: prefill and decode at full width
    lm = lm_phase(dev)

    # ---------- the mesh-only parallel code on 4 logical shards of card 0
    lm_mesh_rec = lm_mesh_phase(dev)

    # ---------------------- training over a mesh, 4 logical shards of card 0
    lm_train_rec = lm_train_mesh_phase(dev)

    # ------------------ the graph family over 4 logical shards of card 0
    gnn_mesh_rec = gnn_mesh_phase(dev)

    # ----------------------- the dry-run matrix: counts, one-card runs
    dry = dryrun_phase(dev)
    progress(f"dryrun: {dry['cells']} cells, phase {dry['wall_s']:.1f} s")

    # ----------------------------------------- kernels vs plain, timed
    if cap.k3 is None or cap.k4 is None or cap.k4_dense is None:
        fail("no build round was captured for the kernel phases")
    k1_gnn = gnn["features"]["k1_launches"]
    kernels = [
        ragged_kernel_phase(srv_e.engine, qrec, False,
                            launches["wcsd_query_ragged"] + k1_gnn, 50),
        ragged_kernel_phase(srv_e.engine, prec, True,
                            launches["wcsd_profile_ragged"], 50),
        prune_kernel_phase(cap.k3, launches["wc_prune_emit_batched"],
                           steps["wc_prune_emit"], floor_s, 50),
        relax_kernel_phase(cap.k4, cap.k4_dense,
                           launches["wc_relax_batched"],
                           steps["wc_relax_batched"], 50),
    ] + comp_kernels + bp_kernels + pad_kernels + relax_kernels \
        + xdf_kernels + train_kernels
    kernels[0].update(main_launches=launches["wcsd_query_ragged"],
                      gnn_launches=k1_gnn)
    for k in kernels:   # K9 and K11 also ran on the dry run's path
        if k["name"] in dry["launches"]:
            k.update(dryrun_launches=dry["launches"][k["name"]])
            k["launches"] += dry["launches"][k["name"]]
    for k in kernels:
        if k["max_abs_err"] > k.get("max_abs_tol", 0):
            fail(f"kernel {k['name']} differs from its plain version "
                 f"(max abs err {k['max_abs_err']})")
    c1 = c1_phase(cap.k3, cap.k4, cap.k4_dense)

    emit(tool)
    for k in kernels:
        emit({"phase": "kernel", **k})
    emit(c1)
    emit(build)
    emit(serve)
    emit(fallback)
    emit(comp_serve)
    emit(ladder)
    emit(sharded)
    emit(bp_serve)
    emit(pad_serve)
    emit(relax)
    emit(gnn)
    emit(dyn)
    emit(xdf)
    emit(train)
    emit(examples)
    emit(lm)
    emit(lm_mesh_rec)
    emit(lm_train_rec)
    emit(gnn_mesh_rec)
    emit(dry)
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in kernels]})
    print(tool["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
