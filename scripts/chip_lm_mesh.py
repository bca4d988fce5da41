#!/usr/bin/env python3
"""The mesh-only parallel code of the port over four cards.

    python3 scripts/chip_lm_mesh.py [--out FILE] [--steps N]
        [--cells llama_long,qwen_ep,gpipe,llama_train,qwen_train,
                 dbrx_decode,dbrx_prefill]

Needs four CUDA devices (a ("data", "model") 1 x 4 mesh, card k shard
k, unless a cell says otherwise). Runs the cells ``--cells`` names (all
by default), each with its checks:

- llama3-8b long_500k at full width and depth (32 layers, bf16 served
  copy from seed 0 on card 0, where the weights stay): one row, its
  524,288-long cache split into 4 sequence blocks of 17.2 GB, one a
  card, filled from a seeded generator on each card (in place of a
  prefill); ``--steps`` greedy steps (default 24) at the last positions,
  each timed between syncs of every card; the median against the bytes
  bound of card 0 (its weights and its block, at `launch.roofline`'s
  HBM rate); the per-card peak above the start; one step traced, busy
  ms a card and card 0's idle share. The check: the same steps over an
  8-shard ("data", "model") 2 x 4 mesh on the same cards (two shards a
  card: each 4-shard block seen as two halves), teacher-forced on the
  4-shard tokens: greedy tokens equal at `BF16_GREEDY_SHARE` of the
  steps (`tests/test_torch_lm.py`'s bar for bf16 decode tokens) and
  every step within `BF16_JUMP` of max |ref| (bf16 at 32 layers of
  random weights: the two splits sum the softmax in another order, a
  bf16 rounding of p flips, and 32 layers of the reference's init,
  fan-in L, amplify it to 3.5-7.4% of max |ref| of the logits); then
  at 2 layers of float32 masters, 4 against 8 shards within 1e-4 of
  max |ref| and greedy tokens all equal, the tight check; then a 2^17
  cut at full depth against the unsharded `decode_step` on card 0
  (`chip_smoke.long_cut_run`), held as the bf16 check.
- qwen2-moe-a2.7b decode_32k at full width and depth (bf16 served
  copy): 8 rows over a seeded 32,768-long cache split over the cards,
  every leaf stored by its spec (`transformer.shard_params`: 16 of 64
  experts a card, which `moe_ffn_replicated_ep` runs there in every
  layer; each card's block of every other leaf, gathered onto card 0 a
  layer at a time); ``--steps`` steps timed; and
  at an 8,192-long cache the same steps over the 4 cards against 4
  logical shards of card 0 (held as the bf16 check).
- `gpipe_forward` over the 4 cards against the stages in turn on card 0
  (`chip_smoke.gpipe_check`).
- ``llama_train``: llama3-8b train_4k at full width and depth (32
  layers, 8.03 B float32 masters, bf16 compute) over ("data", "model")
  4 x 1: every leaf and its AdamW moments stored by their specs, each
  card drawing its own blocks (`init_params(mesh=)`); the global batch
  of 256 rows x 4,096 cut to one row a card, ``--train-steps`` steps
  (the first a warm-up) timed between syncs of every card, the median
  against the FLOP bound of one card's row (8 N T with the recompute,
  plus the causal attention, at `launch.roofline.PEAK_FLOPS`); each
  card's peak; one step traced (busy ms and idle share a card); each
  card's parameter and moment bytes against the sum of its blocks; then
  two rows a card through ``accum_steps=2``. The check:
  `chip_smoke.lm_train_check` over the 4 cards (three float32 steps at
  2 layers against the unsharded steps on card 0) and
  `chip_smoke.lm_train_witness` (the gradient over the 4 cards against
  the whole batch's on card 0, held in float64).
- ``qwen_train``: qwen2-moe-a2.7b train_4k over ("data", "model")
  1 x 4 (16 of 64 padded experts a card), one row of 4,096 tokens (the
  global batch of 256 rows cut to 1), float32 masters and AdamW state
  stored by their specs, ``--train-steps`` donated steps; card 0's peak
  reckoned on the blocks' shapes first (`train_reckoning`; the depth is
  cut only past `CARD_SHARE` of the card); the median of steps 2 on
  against card 0's FLOP bound (`moe_train_bound`), each card's peak and
  idle share, the dropped share; then 2 float32 layers over the 4
  cards against 4 logical shards of card 0 (`qwen_train_check`). Its
  summary lines go to stdout before the record.
- ``dbrx_decode``: dbrx-132b decode_32k at full width and depth (40
  layers, 131.6 B bf16 parameters) over ("data", "model") 1 x 4, each
  card drawing its blocks (4 of the 16 experts, its block of every other
  leaf); `DBRX_ROWS` rows over a seeded 32,768-long cache split along
  its sequence; ``--steps`` greedy steps timed, the median against the
  bytes bound of card 0 (its experts, every non-expert leaf it computes
  with, its cache block, at `launch.roofline.HBM_BW`); each card's peak;
  one step traced. The check: at `DBRX_CHECK_LAYERS` layers and an
  8,192-long cache, the same steps over the 4 cards against 4 logical
  shards of card 0, logits and tokens bit for bit.
- ``dbrx_prefill``: dbrx-132b prefill_32k at full width and depth over
  the same 1 x 4 mesh, each card drawing its blocks: one row (the
  reference's batch of 32 cut to 1) of `DBRX_PROMPT` tokens from
  `TokenStream` through `transformer.prefill_step` over the stored
  leaves into a `DBRX_PREFILL_LEN`-long sequence-sharded cache (the
  head at the last position only), timed between syncs of every card,
  against card 0's FLOP bound (`prefill_bound`) and
  `lm_flops_prefill`; each card's peak against its blocks, its cache
  block and `chip_smoke.prefill_transients`; ``--steps`` greedy decode
  steps from the prefilled cache, timed; a second prefill traced (busy
  ms and idle share a card). The check: at `DBRX_CHECK_LAYERS` layers and a
  `DBRX_CHECK_PROMPT`-token prompt, the same prefill and
  `chip_smoke.LM_MESH_STEPS` decode steps over the 4 cards against 4
  logical shards of card 0: the next token, every cache block and the
  decode logits bit for bit.

No kernel of the port runs (the counts stay 0). Prints one JSON line
(appended to ``--out``) with the cards' names and power limits,
``nvidia-smi topo -m`` and which cards reach each other's memory
(`torch.cuda.can_device_access_peer`), and every check that missed;
then exits non-zero if any did.
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
# train_4k's activations and dbrx's weights and cache come near a card's
# memory: segments that grow keep the free space in one piece (every
# cell runs under it)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import chip_smoke as cs  # noqa: E402  (puts the checkout's src/ on the path)

CARDS = 4
QWEN_ROWS = 8
QWEN_LEN = 32768
QWEN_CHECK_LEN = 8192
CUT_LEN = 1 << 17
TRAIN_SEQ = 4096         # train_4k's sequence; one row a card
DBRX_ROWS = 8            # decode_32k rows (cut from 128)
DBRX_LEN = 32768
DBRX_CHECK_LEN = 8192
DBRX_CHECK_LAYERS = 2    # four logical shards of card 0 hold 2 layers
DBRX_PROMPT = 32768      # prefill_32k's sequence, one row (cut from 32)
DBRX_PREFILL_LEN = DBRX_PROMPT + 1024   # the cache: room to decode
DBRX_CHECK_PROMPT = 8192
QWEN_TRAIN_CHECK_LAYERS = 2
CARD_SHARE = 0.9         # of a card's memory a reckoned peak may take
CELLS = ("llama_long", "qwen_ep", "gpipe", "llama_train", "qwen_train",
         "dbrx_decode", "dbrx_prefill")
BF16_GREEDY_SHARE = 0.5
BF16_JUMP = 0.1
MISSES: list = []


def check_bf16(what: str, errs, equal_share: float) -> None:
    """A bf16 comparison of two splits of the same math: greedy tokens
    equal at `BF16_GREEDY_SHARE` of the steps, every step within
    `BF16_JUMP` of max |ref|."""
    worst = max(e["max"] for e in errs)
    if equal_share < BF16_GREEDY_SHARE or worst > BF16_JUMP:
        MISSES.append(f"{what}: greedy share {equal_share}, max "
                      f"{worst} of max |ref|")


def greedy_share(a, b) -> float:
    return float((a.cpu() == b.cpu()).double().mean())


def trace_by_card(fn, devices, warm: bool = True) -> dict:
    """One call of ``fn`` (after a warm-up call, unless ``warm`` is
    False) under a `torch.profiler` CUDA trace: kernel ms by card and
    the call's wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    cs.sync_all(devices)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        cs.sync_all(devices)
        wall = (time.perf_counter() - t0) * 1e3
    busy: dict = {}
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy[e.device_index] = busy.get(e.device_index, 0.0) + ms
            by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall,
            "busy_ms": {str(k): v for k, v in sorted(busy.items())},
            "idle_share": {str(k): max(0.0, 1 - v / wall)
                           for k, v in sorted(busy.items())},
            "top_kernels_ms": dict(top)}


def halves(cache: dict) -> dict:
    """A sequence-sharded cache's blocks each seen as two halves (views):
    the 8-shard split of the same storage."""
    out = {}
    for kv, blocks in cache.items():
        out[kv] = []
        for b in blocks:
            h = b.shape[2] // 2
            out[kv] += [b.narrow(2, 0, h), b.narrow(2, h, h)]
    return out


def four_vs_eight(cfg, params, cards, steps, seed, time_it: bool) -> dict:
    """``cfg`` over the 4-card mesh, then over the 8-shard mesh on the
    same blocks (fed the 4-shard tokens)."""
    import torch
    from repro_torch.data.lm import TokenStream
    mesh4 = cs.lm_mesh(cards)
    mesh8 = cs.lm_mesh([c for c in cards for _ in (0, 1)],
                       axes={"data": 2, "model": CARDS})
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, 1, seed=0)
                             .next_batch()["tokens"][:, 0]).to(cards[0])
    positions = list(range(cs.LM_LONG - steps, cs.LM_LONG))
    cache = cs.seeded_cache(cfg, 1, cs.LM_LONG, mesh4, seed)
    cs.sync_all(cards)
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    reset_peaks(cards)
    four = cs.decode_run(params, cfg, cache, first, positions, mesh=mesh4,
                         devices=cards)
    rec = {"layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
           "positions": [positions[0], positions[-1]], "steps": steps,
           "peak_gb_above_start": {
               str(c): (torch.cuda.max_memory_allocated(c) - base[c]) / 1e9
               for c in cards},
           "peak_gb": {str(c): torch.cuda.max_memory_allocated(c) / 1e9
                       for c in cards}}
    if time_it:
        from repro_torch.models import transformer as T
        last = four["fed"][-1]
        rec["traced_step"] = trace_by_card(
            lambda: T.decode_step(params, cfg, cache, last, positions[-1],
                                  mesh=mesh4), cards)
    eight = cs.decode_run(params, cfg, halves(cache), None, positions,
                          mesh=mesh8, devices=cards, feed=four["fed"])
    errs = [cs.position_errors(a, b) for a, b in zip(eight["logits"],
                                                     four["logits"])]
    rec.update({
        "step_ms": [t * 1e3 for t in four["step_s"]],
        "step_ms_median": float(np.median(four["step_s"])) * 1e3,
        "eight_shard_step_ms_median": float(np.median(eight["step_s"]))
        * 1e3,
        "rel_err_8_vs_4": [e["max"] for e in errs],
        "max_rel_err_8_vs_4": max(e["max"] for e in errs),
        "median_rel_err_8_vs_4": float(np.median([e["max"] for e in errs])),
        "greedy_share": greedy_share(four["tokens"], eight["tokens"]),
        "errors": errs,
        **cs.long_decode_bound(cfg, params, cs.LM_LONG, CARDS)})
    del cache
    torch.cuda.empty_cache()
    return rec


def llama_long(cards, steps) -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    base = get_arch("llama3-8b").get_config()
    t0 = time.perf_counter()
    model = T.LM(base, device=cards[0], seed=0, dtype=torch.bfloat16)
    cs.sync_all(cards)
    out = {"init_s": time.perf_counter() - t0}
    params = C.param_tree(model)
    full = four_vs_eight(base, params, cards, steps, 1, True)
    out["full_depth_bf16"] = full
    cs.progress(f"long_500k x {base.n_layers} layers over {CARDS} cards: "
                f"{full['step_ms_median']:.2f} ms a step (bound "
                f"{full['bound_ms']:.2f}); 8 shards "
                f"{full['eight_shard_step_ms_median']:.2f}; greedy share "
                f"{full['greedy_share']}, max {full['max_rel_err_8_vs_4']}")
    check_bf16("long_500k 8 vs 4 shards", full["errors"],
               full["greedy_share"])
    cut = cs.long_cut_run(base, params, cs.lm_mesh(cards), cards[0],
                          max_len=CUT_LEN)
    share = float(np.mean([e["argmax_equal"] for e in cut["errors"]]))
    check_bf16("long_500k 2^17 cut vs unsharded", cut["errors"], share)
    out["cut_2e17_vs_unsharded_bf16"] = dict(cut, greedy_share=share)
    del model, params
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(base, n_layers=cs.LM_MESH_FP32_LAYERS,
                               compute_dtype="float32")
    model = T.LM(cfg2, device=cards[0], seed=0)
    fp32 = four_vs_eight(cfg2, C.param_tree(model), cards, cs.LM_MESH_STEPS,
                         2, False)
    del model
    torch.cuda.empty_cache()
    if fp32["greedy_share"] < 1 or fp32["max_rel_err_8_vs_4"] \
            > cs.LM_MESH_TOL:
        MISSES.append(f"long_500k fp32: 8 shards vs 4 "
                      f"{fp32['max_rel_err_8_vs_4']} of max |ref| (tol "
                      f"{cs.LM_MESH_TOL}), greedy share "
                      f"{fp32['greedy_share']}")
    out["fp32_2_layers"] = fp32
    return out


def qwen_ep(cards, steps) -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    cfg = get_arch("qwen2-moe-a2.7b").get_config()
    model = T.LM(cfg, device=cards[0], seed=0, dtype=torch.bfloat16)
    params = C.param_tree(model)
    mesh = cs.lm_mesh(cards)
    logical = cs.lm_mesh([cards[0]] * CARDS)
    placed = T.shard_params(params, cfg, mesh)
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, QWEN_ROWS, seed=0)
                             .next_batch()["tokens"][:, 0]).to(cards[0])
    out = {"rows": QWEN_ROWS, "experts_per_card":
           cfg.moe.padded_experts // CARDS}
    cache = cs.seeded_cache(cfg, QWEN_ROWS, QWEN_LEN, mesh, 3)
    positions = list(range(QWEN_LEN - steps, QWEN_LEN))
    run = cs.decode_run(placed, cfg, cache, first, positions, mesh=mesh,
                        devices=cards)
    out["decode_32k"] = {
        "max_len": QWEN_LEN, "steps": steps,
        "step_ms_median": float(np.median(run["step_s"])) * 1e3,
        "step_ms": [t * 1e3 for t in run["step_s"]],
        "peak_gb": {str(c): torch.cuda.max_memory_allocated(c) / 1e9
                    for c in cards}}
    del cache, run
    torch.cuda.empty_cache()
    positions = list(range(QWEN_CHECK_LEN - cs.LM_MESH_STEPS,
                           QWEN_CHECK_LEN))
    runs = {}
    for name, m, p in (("cards", mesh, placed),
                       ("card0_logical", logical, params)):
        cache = cs.seeded_cache(cfg, QWEN_ROWS, QWEN_CHECK_LEN, m, 4)
        runs[name] = cs.decode_run(p, cfg, cache, first, positions, mesh=m,
                                   devices=m.physical_devices(),
                                   feed=runs["cards"]["fed"]
                                   if runs else None)
        del cache
        torch.cuda.empty_cache()
    errs = [cs.position_errors(a, b) for a, b in
            zip(runs["cards"]["logits"], runs["card0_logical"]["logits"])]
    share = greedy_share(runs["cards"]["tokens"],
                         runs["card0_logical"]["tokens"])
    check_bf16("qwen2-moe EP 4 cards vs 4 logical shards of card 0", errs,
               share)
    out["check_8192"] = {
        "max_rel_err": max(e["max"] for e in errs), "greedy_share": share,
        "cards_step_ms_median": float(np.median(runs["cards"]["step_s"]))
        * 1e3,
        "card0_step_ms_median": float(np.median(
            runs["card0_logical"]["step_s"])) * 1e3}
    del model, params, placed
    torch.cuda.empty_cache()
    return out


def peaks(cards) -> dict:
    import torch
    return {str(c): torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}


def reset_peaks(cards) -> None:
    """Reset each card's peak (a card no tensor has touched yet has no
    allocator to reset: touch it first)."""
    import torch
    for c in cards:
        torch.empty(0, device=c)
        torch.cuda.reset_peak_memory_stats(c)


def train_bound(cfg, rows: int, seq: int) -> dict:
    """One card's FLOP bound for ``rows`` rows of ``seq`` tokens: 8 N T
    (forward, the full recompute, backward) plus the causal attention
    (2 T^2 H Dh a layer forward, four times), at `PEAK_FLOPS`."""
    from repro_torch.launch.roofline import PEAK_FLOPS
    dense = 8.0 * cfg.active_param_count() * rows * seq
    attn = 4 * 2.0 * cfg.n_layers * rows * seq * seq * cfg.n_heads \
        * cfg.d_head
    flops = dense + attn
    return {"flops": flops, "dense_flops": dense, "attention_flops": attn,
            "bound_ms": flops / PEAK_FLOPS * 1e3, "bound_by": "operations"}


def timed_steps(step, p, o, batch, n, cards) -> tuple:
    secs, losses = [], []
    for _ in range(n):
        cs.sync_all(cards)
        t0 = time.perf_counter()
        p, o, met = step(p, o, batch)
        losses.append(float(met["loss"]))
        cs.sync_all(cards)
        secs.append(time.perf_counter() - t0)
    return p, o, secs, losses


def step_parts(cfg, params, batch, mesh, cards) -> dict:
    """A train step's parts, each timed between syncs of every card: the
    loss alone (no gradient), then the loss and its gradient
    (`value_and_grad`, with the recompute), on the step's batch."""
    import torch
    from repro_torch.launch.mesh import split_rows
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import value_and_grad
    b = {k: split_rows(v, mesh) for k, v in batch.items()}
    out = {}
    for name, fn in (("forward_s", lambda: T.loss_fn(params, cfg, b)),
                     ("forward_backward_s", lambda: value_and_grad(
                         lambda p, bb: T.loss_fn(p, cfg, bb))(params, b))):
        cs.sync_all(cards)
        t0 = time.perf_counter()
        with torch.set_grad_enabled(name != "forward_s"):
            res = fn()
        cs.sync_all(cards)
        out[name] = time.perf_counter() - t0
        del res
    return out


def llama_train(cards, steps) -> dict:
    """llama3-8b train_4k at full width and depth over the 4 cards
    (see the module's note)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    cfg = get_arch("llama3-8b").get_config()
    mesh = cs.lm_mesh(cards, axes={"data": CARDS, "model": 1})
    reset_peaks(cards)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                           mesh=mesh)
    cs.sync_all(cards)
    out = {"layers": cfg.n_layers, "params": cfg.param_count(),
           "mesh": {"data": CARDS, "model": 1}, "seq": TRAIN_SEQ,
           "init_s": time.perf_counter() - t0, "init_peak_gb": peaks(cards)}
    ocfg = O.OptimizerConfig()
    opt = O.init_opt_state(ocfg, params)
    stream = TokenStream(cfg.vocab, TRAIN_SEQ, CARDS, seed=0)
    batch = stream.next_batch()
    loss = lambda p, b: T.loss_fn(p, cfg, b)  # noqa: E731
    # the reference's cell donates the parameters and the state: updated
    # in place, no second copy of the 24.1 GB a card at the update
    step = make_train_step(loss, ocfg, mesh=mesh, donate=True)
    reset_peaks(cards)
    params, opt, secs, losses = timed_steps(step, params, opt, batch, steps,
                                            cards)
    out["one_row_a_card"] = {
        "rows": CARDS, "donate": True, "step_s": secs, "losses": losses,
        "step_s_median": float(np.median(secs[1:])),
        "peak_gb": peaks(cards), **train_bound(cfg, 1, TRAIN_SEQ)}
    rec = out["one_row_a_card"]
    cs.progress(f"train_4k steps: {json.dumps(rec)}")
    rec.update(step_parts(cfg, params, batch, mesh, cards))
    rec["traced_step"] = trace_by_card(lambda: step(params, opt, batch),
                                       cards)
    rec["state"] = cs.block_accounting([params, opt.m, opt.v], mesh)
    rec["allocated_gb"] = {str(c): torch.cuda.memory_allocated(c) / 1e9
                           for c in cards}
    if not rec["state"]["equal"]:
        MISSES.append(f"train_4k: a card holds more than its blocks "
                      f"({rec['state']})")
    if not all(np.isfinite(losses)):
        MISSES.append(f"train_4k: losses {losses}")
    cs.progress(f"train_4k x {cfg.n_layers} layers, 1 row a card: "
                f"{rec['step_s_median']:.3f} s a step (bound "
                f"{rec['bound_ms'] / 1e3:.3f}), peak {rec['peak_gb']} GB, "
                f"idle {rec['traced_step']['idle_share']}")
    cs.progress(f"train_4k record: {json.dumps(rec)}")
    reset_peaks(cards)
    step2 = make_train_step(loss, ocfg, accum_steps=2, mesh=mesh,
                            donate=True)
    two = {k: np.concatenate([batch[k], stream.next_batch()[k]])
           for k in batch}
    params, opt, secs, losses = timed_steps(step2, params, opt, two,
                                            max(2, steps // 2), cards)
    out["two_rows_a_card_accum_2"] = {
        "rows": 2 * CARDS, "accum_steps": 2, "donate": True, "step_s": secs,
        "losses": losses, "step_s_median": float(np.median(secs[1:])),
        "peak_gb": peaks(cards), **train_bound(cfg, 2, TRAIN_SEQ)}
    del params, opt
    torch.cuda.empty_cache()
    out["check_fp32_2_layers"] = cs.lm_train_check(mesh, cards[0])
    out["witness_2_layers"] = cs.lm_train_witness(mesh, cards[0])
    return out


def train_reckoning(cfg, mesh, seq: int) -> dict:
    """Each card's peak of a donated AdamW step over parameters stored
    by their specs over ``mesh`` (one device a shard), reckoned from the
    blocks' shapes alone (no tensor is made): float32 masters, m and v;
    the float32 gradients; at the update, two temporaries the size of
    the largest block (`optim.apply_updates`). On card 0, beside the
    state, the head's transients at the backward's start: the logits of
    one row of ``seq`` tokens in the compute dtype, their float32 copy,
    its exponent and gradient, and the gradient cast back."""
    import math
    from repro_torch.launch.mesh import block_region
    from repro_torch.models import transformer as T
    defs, specs = T.param_defs(cfg), T.param_specs(cfg)
    out = {}
    for k, dev in enumerate(mesh.devices):
        sizes = [math.prod(b - a for a, b in block_region(
            shape, specs[path], mesh, k)) * 4 for path, shape in defs.items()]
        held = sum(sizes)
        update = 3 * held + held + 2 * max(sizes)
        out[str(dev)] = {"blocks_gb": held / 1e9,
                         "state_gb": 3 * held / 1e9,
                         "grads_gb": held / 1e9,
                         "largest_block_gb": max(sizes) / 1e9,
                         "at_update_gb": update / 1e9}
    c0 = out[str(mesh.devices[0])]
    logits = seq * cfg.vocab * (2 * T.DTYPES[cfg.compute_dtype].itemsize
                                + 3 * 4)
    c0["head_transients_gb"] = logits / 1e9
    c0["at_head_gb"] = c0["state_gb"] + logits / 1e9
    for rec in out.values():
        rec["peak_gb"] = max(rec["at_update_gb"], rec.get("at_head_gb", 0))
    return out


def moe_train_bound(cfg, rows: int, seq: int) -> dict:
    """Card 0's FLOP bound for a train step of ``rows`` x ``seq`` over a
    1 x `CARDS` mesh (one data shard, on card 0), counted as
    `prefill_bound` counts a prefill: its causal attention, its
    non-expert GEMMs (q, k, v, o, the router, the shared experts, the
    head at every position) and a quarter of the routed experts' (top_k
    choices a token), the forward's count times 4 (the backward's two
    and the recompute's one), at `launch.roofline.PEAK_FLOPS`."""
    from repro_torch.launch.roofline import PEAK_FLOPS
    m, d, N, L = cfg.moe, cfg.d_model, rows * seq, cfg.n_layers
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    attn = 2.0 * L * rows * seq * seq * hq
    dense = 2.0 * N * L * (2 * d * hq + 2 * d * hkv + d * m.padded_experts
                           + 3 * d * m.d_ff_expert * m.num_shared) \
        + 2.0 * N * d * cfg.vocab
    experts = 2.0 * 3 * N * m.top_k * d * m.d_ff_expert * L / CARDS
    flops = 4 * (attn + dense + experts)
    return {"card0_flops": flops, "attention_flops": 4 * attn,
            "dense_flops": 4 * dense, "expert_flops_quarter": 4 * experts,
            "bound_ms": flops / PEAK_FLOPS * 1e3, "bound_by": "operations"}


class EpDrops:
    """Wraps `moe.ep_slots` while a run lasts: each expert shard's
    (token, choice) pairs whose expert is local, and those it keeps
    (tensors; no sync in the run)."""

    def __enter__(self):
        from repro_torch.models import moe
        self._orig, self.local, self.kept = moe.ep_slots, [], []

        def recorded(idx, cfg, capL, e_lo, EL):
            picks = self._orig(idx, cfg, capL, e_lo, EL)
            self.local.append(((idx >= e_lo) & (idx < e_lo + EL)).sum())
            self.kept.append(sum(p[2].sum() for p in picks))
            return picks

        moe.ep_slots = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.ep_slots = self._orig

    def share(self) -> float:
        local = sum(int(n) for n in self.local)
        return 1 - sum(int(n) for n in self.kept) / max(local, 1)


def qwen_train(cards, steps) -> dict:
    """qwen2-moe-a2.7b train_4k over the 4 cards: one row of `TRAIN_SEQ`
    tokens (`TokenStream` seed 0; the global batch of 256 rows cut to
    1), ("data", "model") 1 x 4 (64 padded experts, 16 a card), every
    leaf and its AdamW moments stored by their specs, each card drawing
    its own blocks; the depth `train_reckoning` lets fit `CARD_SHARE` of
    a card (full depth if it fits); ``steps`` donated steps timed
    between syncs of every card, the median of all but the first
    against card 0's FLOP bound (`moe_train_bound`); each card's peak;
    the forward and the forward with its gradient timed; one step
    traced (busy ms and idle share a card); the dropped share of the
    (token, choice) pairs over one forward (`EpDrops`). The check
    (`qwen_train_check`): `QWEN_TRAIN_CHECK_LAYERS` float32 layers over
    the 4 cards against 4 logical shards of card 0."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import split_rows
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    full = get_arch("qwen2-moe-a2.7b").get_config()
    mesh = cs.lm_mesh(cards)
    card_gb = torch.cuda.get_device_properties(cards[0]).total_memory / 1e9
    cfg = full
    reckoned = train_reckoning(cfg, mesh, TRAIN_SEQ)
    while max(r["peak_gb"] for r in reckoned.values()) > CARD_SHARE \
            * card_gb and cfg.n_layers > 1:
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
        reckoned = train_reckoning(cfg, mesh, TRAIN_SEQ)
    out = {"layers": cfg.n_layers, "full_layers": full.n_layers,
           "depth_cut": cfg.n_layers < full.n_layers,
           "full_depth_reckoned": train_reckoning(full, mesh, TRAIN_SEQ),
           "reckoned": reckoned, "card_gb": card_gb,
           "params": cfg.param_count(), "mesh": {"data": 1, "model": CARDS},
           "rows": 1, "seq": TRAIN_SEQ, "donate": True}
    print(f"qwen_train reckoned peak a card (GB): "
          f"{ {k: round(v['peak_gb'], 2) for k, v in reckoned.items()} } "
          f"at {cfg.n_layers} of {full.n_layers} layers, limit "
          f"{CARD_SHARE * card_gb:.2f}", flush=True)
    reset_peaks(cards)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                           mesh=mesh)
    cs.sync_all(cards)
    out.update(init_s=time.perf_counter() - t0, init_peak_gb=peaks(cards))
    ocfg = O.OptimizerConfig()
    opt = O.init_opt_state(ocfg, params)
    batch = TokenStream(cfg.vocab, TRAIN_SEQ, 1, seed=0).next_batch()
    loss = lambda p, b: T.loss_fn(p, cfg, b)  # noqa: E731
    step = make_train_step(loss, ocfg, mesh=mesh, donate=True)
    reset_peaks(cards)
    params, opt, secs, losses = timed_steps(step, params, opt, batch, steps,
                                            cards)
    out.update(step_s=secs, losses=losses,
               step_s_median=float(np.median(secs[1:])),
               peak_gb=peaks(cards), **moe_train_bound(cfg, 1, TRAIN_SEQ))
    cs.progress(f"qwen train_4k steps: {json.dumps(out)}")
    out.update(step_parts(cfg, params, batch, mesh, cards))
    out["traced_step"] = trace_by_card(lambda: step(params, opt, batch),
                                       cards)
    with EpDrops() as drops, torch.no_grad():
        T.loss_fn(params, cfg, {k: split_rows(v, mesh)
                                for k, v in batch.items()})
        cs.sync_all(cards)
    out["dropped_share"] = drops.share()
    out["state"] = cs.block_accounting([params, opt.m, opt.v], mesh)
    if not out["state"]["equal"]:
        MISSES.append(f"qwen train_4k: a card holds more than its blocks "
                      f"({out['state']})")
    if not all(np.isfinite(losses)):
        MISSES.append(f"qwen train_4k: losses {losses}")
    del params, opt
    torch.cuda.empty_cache()
    print(f"qwen_train: {cfg.n_layers} layers, step "
          f"{out['step_s_median']:.4f} s (median of steps 2-{steps}; "
          f"{[round(t, 4) for t in secs]}), card 0 bound "
          f"{out['bound_ms'] / 1e3:.4f} s, peak GB {out['peak_gb']}, idle "
          f"{out['traced_step']['idle_share']}, dropped share "
          f"{out['dropped_share']:.4f}", flush=True)
    out["check"] = qwen_train_check(cards)
    print(f"qwen_train check: {json.dumps(out['check'])}", flush=True)
    return out


def qwen_train_check(cards, steps: int = 3) -> dict:
    """`QWEN_TRAIN_CHECK_LAYERS` layers of qwen2-moe-a2.7b at full width
    in float32 (TF32 off), one row of `TRAIN_SEQ` tokens: ``steps`` AdamW
    steps (warm-up 0) over the 4 cards (1 x 4) against the same over 4
    logical shards of card 0, at `tests/test_torch_cuda.py`'s several-
    cards bars: the losses within 1e-6, the parameters within 1e-5 of
    each leaf's max |ref| (whether they are equal bit for bit is
    recorded)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import join_leaf
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import map_sharded
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").get_config(),
                              n_layers=QWEN_TRAIN_CHECK_LAYERS,
                              compute_dtype="float32")
    batch = TokenStream(cfg.vocab, TRAIN_SEQ, 1, seed=0).next_batch()
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=0)
    runs = {}
    for name, devs in (("cards", cards), ("card0_logical",
                                          [cards[0]] * CARDS)):
        mesh = cs.lm_mesh(devs)
        p = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                          mesh=mesh)
        o = O.init_opt_state(ocfg, p)
        step = make_train_step(lambda pp, b: T.loss_fn(pp, cfg, b), ocfg,
                               mesh=mesh, donate=True)
        p, o, secs, losses = timed_steps(step, p, o, batch, steps,
                                         mesh.physical_devices())
        runs[name] = {"losses": losses, "step_s": secs,
                      "params": C.flatten_params(map_sharded(
                          lambda x: join_leaf(x, cards[0]), p))}
        del p, o, step
        torch.cuda.empty_cache()
    a, b = runs["cards"], runs["card0_logical"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       b["losses"]))
    errs = {k: cs.device_rel_err(v, b["params"][k])
            for k, v in a["params"].items()}
    ok = loss_err <= 1e-6 and max(errs.values()) <= 1e-5
    same = a["losses"] == b["losses"] and all(
        torch.equal(v, b["params"][k]) for k, v in a["params"].items())
    if not ok:
        MISSES.append(f"qwen train check: loss {loss_err}, parameters "
                      f"{max(errs.values())} of max |ref|")
    return {"layers": cfg.n_layers, "seq": TRAIN_SEQ, "steps": steps,
            "losses": a["losses"], "card0_losses": b["losses"],
            "loss_rel_err": loss_err, "param_rel_err": max(errs.values()),
            "param_rel_err_by_leaf": errs, "within_bars": ok,
            "bit_equal": same,
            "cards_step_s": a["step_s"], "card0_step_s": b["step_s"]}


def dbrx_bound(cfg, params, rows: int, max_len: int) -> dict:
    """Card 0's bytes for one decode step over ``params`` (stored by
    their specs over 4 cards): its expert blocks, every other leaf whole
    (it computes with them all), its cache block, at `HBM_BW`."""
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.models import common as C
    from repro_torch.models.moe import EXPERT_LEAVES
    experts = other = 0
    for path, leaf in C.flatten_params(params).items():
        if path.split(".")[-1] in EXPERT_LEAVES:
            experts += leaf[0].numel() * leaf[0].element_size()
        else:
            other += np.prod(leaf.shape) * leaf[0].element_size()
    kv = 2 * cfg.n_layers * rows * max_len * cfg.n_kv_heads \
        * cfg.d_head * 2 / CARDS
    card0 = experts + other + kv
    return {"card0_expert_gb": experts / 1e9, "other_leaves_gb": other / 1e9,
            "card0_cache_gb": kv / 1e9, "card0_gb": card0 / 1e9,
            "bound_ms": card0 / HBM_BW * 1e3, "bound_by": "bytes"}


def dbrx_decode(cards, steps) -> dict:
    """dbrx-132b decode_32k at full width and depth over the 4 cards
    (see the module's note)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    cfg = get_arch("dbrx-132b").get_config()
    mesh = cs.lm_mesh(cards)
    reset_peaks(cards)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                           dtype=torch.bfloat16, mesh=mesh)
    cs.sync_all(cards)
    out = {"layers": cfg.n_layers, "params": cfg.param_count(),
           "rows": DBRX_ROWS, "max_len": DBRX_LEN, "steps": steps,
           "init_s": time.perf_counter() - t0, "init_peak_gb": peaks(cards),
           "resident_gb": {str(c): torch.cuda.memory_allocated(c) / 1e9
                           for c in cards}}
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, DBRX_ROWS, seed=0)
                             .next_batch()["tokens"][:, 0]).to(cards[0])
    cache = cs.seeded_cache(cfg, DBRX_ROWS, DBRX_LEN, mesh, 7)
    positions = list(range(DBRX_LEN - steps, DBRX_LEN))
    reset_peaks(cards)
    run = cs.decode_run(params, cfg, cache, first, positions, devices=cards)
    last = run["fed"][-1]
    out.update({
        "step_ms": [t * 1e3 for t in run["step_s"]],
        "step_ms_median": float(np.median(run["step_s"][1:])) * 1e3,
        "peak_gb": peaks(cards),
        "traced_step": trace_by_card(
            lambda: T.decode_step(params, cfg, cache, last, positions[-1]),
            cards),
        **dbrx_bound(cfg, params, DBRX_ROWS, DBRX_LEN)})
    if not torch.isfinite(run["logits"]).all():
        MISSES.append("dbrx decode_32k: logits not finite")
    cs.progress(f"dbrx decode_32k x {cfg.n_layers} layers, {DBRX_ROWS} rows: "
                f"{out['step_ms_median']:.2f} ms a step (bound "
                f"{out['bound_ms']:.2f}), peak {out['peak_gb']} GB")
    del params, cache, run
    torch.cuda.empty_cache()
    out["check_8192"] = dbrx_check(cards)
    return out


def dbrx_check(cards) -> dict:
    """`DBRX_CHECK_LAYERS` layers of dbrx-132b (bf16 served copy) over the
    4 cards against 4 logical shards of card 0, an 8,192-long cache:
    logits and tokens bit for bit."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("dbrx-132b").get_config(),
                              n_layers=DBRX_CHECK_LAYERS)
    whole = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                          dtype=torch.bfloat16)
    first = torch.from_numpy(TokenStream(cfg.vocab, 1, DBRX_ROWS, seed=0)
                             .next_batch()["tokens"][:, 0]).to(cards[0])
    positions = list(range(DBRX_CHECK_LEN - cs.LM_MESH_STEPS,
                           DBRX_CHECK_LEN))
    runs = {}
    for name, devs in (("cards", cards), ("card0_logical",
                                          [cards[0]] * CARDS)):
        m = cs.lm_mesh(devs)
        placed = T.shard_params(whole, cfg, m)
        cache = cs.seeded_cache(cfg, DBRX_ROWS, DBRX_CHECK_LEN, m, 8)
        runs[name] = cs.decode_run(placed, cfg, cache, first, positions,
                                   devices=m.physical_devices(),
                                   feed=runs["cards"]["fed"]
                                   if runs else None)
        del placed, cache
        torch.cuda.empty_cache()
    same = bool(torch.equal(runs["cards"]["logits"].cpu(),
                            runs["card0_logical"]["logits"].cpu())
                and torch.equal(runs["cards"]["tokens"].cpu(),
                                runs["card0_logical"]["tokens"].cpu()))
    if not same:
        MISSES.append("dbrx decode: 4 cards and 4 logical shards of card 0 "
                      "differ")
    return {"layers": cfg.n_layers, "max_len": DBRX_CHECK_LEN,
            "steps": len(positions), "bit_equal": same,
            "max_rel_err": cs.rel_err(runs["cards"]["logits"],
                                      runs["card0_logical"]["logits"]),
            "cards_step_ms": [t * 1e3 for t in runs["cards"]["step_s"]],
            "card0_step_ms": [t * 1e3 for t in
                              runs["card0_logical"]["step_s"]]}


def prefill_bound(cfg, rows: int, seq: int) -> dict:
    """Card 0's FLOP bound for a prefill of ``rows`` x ``seq`` over
    leaves stored by their specs on `CARDS` cards (one data shard, as
    `dbrx_bound` counts decode's card 0): its causal attention (2 T^2
    H Dh a layer), its non-expert GEMMs (q, k, v, o, the router, the
    head at the last position) and a quarter of the experts' (top_k
    choices a token, 3 GEMMs), at `launch.roofline.PEAK_FLOPS`; beside
    it, the bytes of card 0's blocks at `HBM_BW`."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    m, d, N = cfg.moe, cfg.d_model, rows * seq
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    attn = 2.0 * cfg.n_layers * rows * seq * seq * hq
    dense = 2.0 * N * cfg.n_layers * (2 * d * hq + 2 * d * hkv
                                      + d * m.padded_experts) \
        + 2.0 * rows * d * cfg.vocab
    experts = 2.0 * 3 * N * m.top_k * d * m.d_ff_expert * cfg.n_layers \
        / CARDS
    flops = attn + dense + experts
    return {"card0_flops": flops, "attention_flops": attn,
            "dense_flops": dense, "expert_flops_quarter": experts,
            "bound_ms": flops / PEAK_FLOPS * 1e3, "bound_by": "operations"}


def blocks_gb(params, cards) -> dict:
    """Each card's bytes of the stored leaves' blocks."""
    from repro_torch.launch.mesh import leaf_bytes
    from repro_torch.models import common as C
    leaves = list(C.flatten_params(params).values())
    return {str(c): sum(leaf_bytes(v, c) for v in leaves) / 1e9
            for c in cards}


def dbrx_prefill(cards, steps) -> dict:
    """dbrx-132b prefill_32k at full width and depth over the 4 cards,
    then decode from its cache (see the module's note)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import lm_flops_prefill
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    cfg = get_arch("dbrx-132b").get_config()
    mesh = cs.lm_mesh(cards)
    reset_peaks(cards)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                           dtype=torch.bfloat16, mesh=mesh)
    cs.sync_all(cards)
    held = blocks_gb(params, cards)
    out = {"layers": cfg.n_layers, "params": cfg.param_count(), "rows": 1,
           "prompt": DBRX_PROMPT, "max_len": DBRX_PREFILL_LEN,
           "init_s": time.perf_counter() - t0, "blocks_gb": held,
           "reckoned_transients_card0": cs.prefill_transients(
               cfg, 1, DBRX_PROMPT, CARDS)}
    toks = TokenStream(cfg.vocab, DBRX_PROMPT, 1, seed=0).next_batch()[
        "tokens"]

    def prefill():
        with torch.no_grad():
            return T.prefill_step(params, cfg, toks,
                                  max_len=DBRX_PREFILL_LEN)

    reset_peaks(cards)
    cs.sync_all(cards)
    t0 = time.perf_counter()
    nxt, cache = prefill()
    cs.sync_all(cards)
    wall = time.perf_counter() - t0
    flops = lm_flops_prefill(cfg, 1, DBRX_PROMPT)
    out.update({"prefill_s": wall, "model_flop": flops,
                "model_tflops": flops / wall / 1e12,
                "peak_gb": peaks(cards),
                "cache_gb": {k: v / 1e9 for k, v in
                             cs.cache_bytes(cache).items()},
                **prefill_bound(cfg, 1, DBRX_PROMPT)})
    c0 = str(cards[0])
    out["card0_within_reckoning"] = out["peak_gb"][c0] <= (
        held[c0] + out["cache_gb"][c0]
        + out["reckoned_transients_card0"]["total_gb"])
    cs.progress(f"dbrx prefill_32k x {cfg.n_layers} layers: {wall:.2f} s "
                f"({out['model_tflops']:.1f} TFLOP/s; bound "
                f"{out['bound_ms'] / 1e3:.3f} s), peak {out['peak_gb']} GB")
    positions = list(range(DBRX_PROMPT, DBRX_PROMPT + steps))
    run = cs.decode_run(params, cfg, cache, nxt, positions, devices=cards)
    out.update({
        "decode_steps": steps,
        "decode_step_ms": [t * 1e3 for t in run["step_s"]],
        "decode_step_ms_median": float(np.median(run["step_s"][1:]))
        * 1e3,
        "decode_peak_gb": peaks(cards)})
    if not torch.isfinite(run["logits"]).all():
        MISSES.append("dbrx prefill_32k: decode logits not finite")
    cs.progress(f"dbrx decode after prefill_32k: "
                f"{out['decode_step_ms_median']:.2f} ms a step")
    # the traced prefill makes a cache of its own: free this one first
    del cache, run
    torch.cuda.empty_cache()
    out["traced_prefill"] = trace_by_card(prefill, cards, warm=False)
    cs.progress(f"dbrx prefill_32k traced: {out['traced_prefill']}")
    del params
    torch.cuda.empty_cache()
    out["check_8192"] = dbrx_prefill_check(cards)
    return out


def dbrx_prefill_check(cards) -> dict:
    """`DBRX_CHECK_LAYERS` layers of dbrx-132b (bf16) over the 4 cards
    against 4 logical shards of card 0: a `DBRX_CHECK_PROMPT`-token
    prompt through `prefill_step` over the stored leaves, then
    `chip_smoke.LM_MESH_STEPS` greedy steps (the logical run fed the
    cards' tokens): the next token, every cache block and the decode
    logits bit for bit."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("dbrx-132b").get_config(),
                              n_layers=DBRX_CHECK_LAYERS)
    whole = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                          dtype=torch.bfloat16)
    toks = TokenStream(cfg.vocab, DBRX_CHECK_PROMPT, 1, seed=0).next_batch()[
        "tokens"]
    L = DBRX_CHECK_PROMPT + 1024
    positions = list(range(DBRX_CHECK_PROMPT,
                           DBRX_CHECK_PROMPT + cs.LM_MESH_STEPS))
    runs = {}
    for name, devs in (("cards", cards), ("card0_logical",
                                          [cards[0]] * CARDS)):
        m = cs.lm_mesh(devs)
        placed = T.shard_params(whole, cfg, m)
        cs.sync_all(m.physical_devices())
        t0 = time.perf_counter()
        with torch.no_grad():
            nxt, cache = T.prefill_step(placed, cfg, toks, max_len=L)
        cs.sync_all(m.physical_devices())
        prefill_s = time.perf_counter() - t0
        blocks = {k: [b.cpu() for b in v] for k, v in cache.items()}
        run = cs.decode_run(placed, cfg, cache, nxt, positions,
                            devices=m.physical_devices(),
                            feed=runs["cards"]["fed"] if runs else None)
        run.update(next=nxt.cpu(), blocks=blocks, prefill_s=prefill_s)
        runs[name] = run
        del placed, cache
        torch.cuda.empty_cache()
    a, b = runs["cards"], runs["card0_logical"]
    same = {"next": bool(torch.equal(a["next"], b["next"])),
            "cache": all(torch.equal(x, y) for k in ("k", "v")
                         for x, y in zip(a["blocks"][k], b["blocks"][k])),
            "logits": bool(torch.equal(a["logits"].cpu(),
                                       b["logits"].cpu())),
            "tokens": bool(torch.equal(a["tokens"].cpu(),
                                       b["tokens"].cpu()))}
    if not all(same.values()):
        MISSES.append(f"dbrx prefill: 4 cards and 4 logical shards of card "
                      f"0 differ ({same})")
    return {"layers": cfg.n_layers, "prompt": DBRX_CHECK_PROMPT,
            "max_len": L, "steps": len(positions), "bit_equal": same,
            "max_rel_err": cs.rel_err(a["logits"], b["logits"]),
            "cards_prefill_s": a["prefill_s"],
            "card0_prefill_s": b["prefill_s"],
            "cards_step_ms": [t * 1e3 for t in a["step_s"]],
            "card0_step_ms": [t * 1e3 for t in b["step_s"]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--train-steps", type=int, default=5)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args()
    cells = args.cells.split(",")
    if set(cells) - set(CELLS):
        ap.error(f"--cells takes {', '.join(CELLS)}")
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < CARDS:
        print(f"chip_lm_mesh: needs {CARDS} CUDA devices, found {n}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cards = [torch.device("cuda", i) for i in range(CARDS)]
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rec = {}

    def run(name, fn, *a):
        # a cell that fails is a miss (the script exits non-zero); the
        # next cell still runs
        try:
            return fn(*a)
        except (Exception, SystemExit) as e:  # noqa: BLE001
            MISSES.append(f"{name}: {type(e).__name__}: {e}")
            cs.progress(f"{name} failed: {type(e).__name__}: {e}")
            torch.cuda.empty_cache()
            return {"failed": f"{type(e).__name__}: {e}"}

    if "llama_long" in cells:
        rec["llama3_8b_long_500k"] = llama_long(cards, args.steps)
    if "qwen_ep" in cells:
        rec["qwen2_moe_decode_32k_ep"] = qwen_ep(cards, args.steps)
    if "gpipe" in cells:
        rec["gpipe"] = cs.gpipe_check(cards, cards[0])
    if "llama_train" in cells:
        rec["llama3_8b_train_4k"] = run("train_4k", llama_train, cards,
                                        args.train_steps)
    if "qwen_train" in cells:
        rec["qwen2_moe_train_4k"] = run("qwen train_4k", qwen_train, cards,
                                        args.train_steps)
    if "dbrx_decode" in cells:
        rec["dbrx_132b_decode_32k"] = run("dbrx decode_32k", dbrx_decode,
                                          cards, args.steps)
    if "dbrx_prefill" in cells:
        rec["dbrx_132b_prefill_32k"] = run("dbrx prefill_32k", dbrx_prefill,
                                           cards, args.steps)
    cs.sync_all(cards)
    launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if launched:
        cs.fail(f"chip_lm_mesh launched kernels of the port: {launched}")
    rec["wall_s"] = time.perf_counter() - t0
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    rec["topology"] = (topo.stdout + topo.stderr).strip()
    rec["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(i, j)
                           for j in range(CARDS)] for i in range(CARDS)]
    rec["misses"] = MISSES
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if MISSES:
        print("chip_lm_mesh: FAILED: " + "; ".join(MISSES), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
