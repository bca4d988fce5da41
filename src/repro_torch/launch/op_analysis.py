"""Count a step's work from the ops it runs: the port's counterpart of the
reference's `launch/hlo_analysis.py`.

The reference compiles each dry-run cell with XLA and parses the
compiled HLO text for its FLOPs, HBM bytes and collectives. The port has
no compiler between its Python and the card, hence no HLO: every aten op
is (about) one kernel launch, and the port's own CUDA kernels are calls
of `kernels.ops`. So `count_step` runs the step once on meta tensors,
which carry shapes and dtypes and no data, under `OpCounter`, and counts:

  * flops: dot / matmul / convolution only, the reference's convention
    (2 x result elements x contracted size; elementwise work excluded),
    by the formulas of `torch.utils.flop_counter.FlopCounterMode` (its
    `flop_registry`, read per op here, so one dispatch mode counts
    everything) and 2 M N for the matrix-vector products it leaves out
    (`mv`, `dot`), plus the FLOPs the
    port's kernels report from their meta routes (K11, K11-narrow and K12
    add 2 B H M K D, the CIN contraction the reference counts as dots);
  * hbm_bytes: each aten op's tensor operands and results, each counted
    once per op (a dimension of stride 0 once), where the reference sums
    its top-level HLO ops' operands and results; views and allocations
    move none; plus the bytes the kernels report (inputs read once, the
    output written once);
  * moved_bytes: hbm_bytes with the source of a gather (`index_select`,
    `embedding`, `index`, `gather`) charged only the bytes of the rows it
    reads, no more than its result's, where hbm_bytes charges the whole
    table (xDeepFM's serve steps read 512 x 39 rows of a 321 MB one);
    the roofline's memory term (`launch.roofline`) reads this one;
  * int_ops: the integer operations the kernels report (K9: at most 2L
    compares and L meets at 2 ops a query, the meets counted all, since
    they depend on the rows);
  * kernels: calls, flops, int_ops and bytes per kernel;
  * peak_live_bytes: the most bytes that storages held at once, the
    arguments' from the start (the step's own frees, autograd's saved
    tensors and its outputs included);
  * ops: the aten ops that move bytes.

The count is of the global (unpartitioned) step: there is no SPMD
partitioner, so no collective is counted.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import ops as kops
from ..train.tree import tree_leaves

# ops that are not views by their schema but move no bytes: allocations
# and a reshape of a contiguous tensor
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "lift_fresh", "lift_fresh_copy"}


_aten = torch.ops.aten
# ops whose first operand is a table they read only some rows of
_GATHERS = {_aten.index_select, _aten.embedding, _aten.index, _aten.gather,
            _aten._unsafe_index}
# dots FlopCounterMode has no formula for
_EXTRA_FLOPS = {_aten.mv: lambda a, b, *_, **__: 2 * a.shape[0] * a.shape[1],
                _aten.dot: lambda a, b, *_, **__: 2 * a.shape[0]}


def touched_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span, a dimension of stride 0 once."""
    return t.element_size() * math.prod(
        n for n, st in zip(t.shape, t.stride()) if st != 0)


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _tensors(xs) -> list:
    """The tensors of an op's arguments or results (a tensor, or a flat
    sequence holding tensors and lists of them)."""
    if torch.is_tensor(xs):
        return [xs]
    out = []
    for x in xs:
        if torch.is_tensor(x):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if torch.is_tensor(t))
    return out


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (FLOPs, bytes, op count, live
    storages) and the kernel work `kernels.ops` reports from its meta
    routes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.moved_bytes = 0
        self.ops = 0
        self.kernels: dict = {}
        self.live = 0
        self.peak_live = 0
        self._tracked = WeakIdKeyDictionary()
        self._moves = {}        # op -> whether it moves bytes

    def __enter__(self):
        kops.WORK_SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kops.WORK_SINKS.remove(self)
        return super().__exit__(*exc)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` as live until freed."""
        for t in tensors:
            st = t.untyped_storage()
            if st in self._tracked:
                continue
            n = st.nbytes()
            self._tracked[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak_live = max(self.peak_live, self.live)

    def add_kernel(self, kernel: str, *, flops: int, int_ops: int,
                   nbytes: int) -> None:
        rec = self.kernels.setdefault(
            kernel, {"calls": 0, "flops": 0, "int_ops": 0, "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["int_ops"] += int_ops
        rec["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = not (
                func.is_view or func.__name__.split(".")[0] in _FREE)
        if moves:
            ins = _tensors(args) + _tensors(kwargs.values())
            nbytes = sum(touched_bytes(t) for t in ins + outs)
            self.hbm_bytes += nbytes
            packet = func._overloadpacket
            if packet in _GATHERS:
                table = touched_bytes(args[0])
                nbytes += min(table, sum(touched_bytes(t) for t in outs)) \
                    - table
            self.moved_bytes += nbytes
            self.ops += 1
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            elif packet in _EXTRA_FLOPS:
                self.flops += _EXTRA_FLOPS[packet](*args, **kwargs)
        self.track(outs)
        return out


def count_step(fn, args: tuple):
    """Run ``fn(*args)`` (meta-tensor arguments) under an `OpCounter`.
    Returns (its result, the counts as a dict: flops, hbm_bytes,
    moved_bytes, int_ops, kernels, peak_live_bytes, ops)."""
    with OpCounter() as oc:
        oc.track([t for t in tree_leaves(args) if torch.is_tensor(t)])
        out = fn(*args)
    ks = oc.kernels.values()
    return out, {
        "flops": float(oc.flops + sum(k["flops"] for k in ks)),
        "hbm_bytes": float(oc.hbm_bytes + sum(k["bytes"] for k in ks)),
        "moved_bytes": float(oc.moved_bytes + sum(k["bytes"] for k in ks)),
        "int_ops": float(sum(k["int_ops"] for k in ks)),
        "kernels": oc.kernels,
        "peak_live_bytes": int(oc.peak_live),
        "ops": oc.ops,
    }
