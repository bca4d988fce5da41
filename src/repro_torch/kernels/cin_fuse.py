"""The xDeepFM CIN layer, K11 (the reference's `kernels/cin_fuse.py:
cin_layer`): its CUDA launcher and, beside it, its plain PyTorch version.

    out[b, k, d] = sum_{h, m} w[k, h, m] * x1[b, h, d] * x0[b, m, d]

x1 [B, H, D], x0 [B, M, D], w [K, H, M] -> [B, K, D] float32. On the
card a call goes to one of two CUDA kernels (3xTF32 on the tensor
cores): float32 calls with at most `CIN_NARROW_MAX_K` output channels
(the CIN backward's dx0, and dx1 of the first layer) to the narrow
instance `repro_torch/csrc/cin_narrow.cu`, which never forms the outer
product and takes any M; every other call (the forward, serving, and
bfloat16 at any K) to the wide kernel `repro_torch/csrc/cin_fuse.cu`.
The plain version translates the reference's `kernels/ref.py:
cin_layer_ref`, in the TPU kernel's form (the outer product z as a
[b*D, H*M] matrix against w as [H*M, K]), chunked over B so that z
stays under `CIN_CHUNK_BYTES`: unchunked it would be B*H*M*D floats,
81.8 GB at B = 262,144 and the model's widths.

K12, the weight gradient of a CIN layer (`cin_weight_grad_cuda`, CUDA
source `repro_torch/csrc/cin_grad.cu`, 3xTF32 on the tensor cores), and
its plain version `cin_weight_grad_plain` live here too:

    dw[k, h, m] = sum_{b, d} g[b, k, d] * x1[b, h, d] * x0[b, m, d]

g [B, K, D], x1 [B, H, D], x0 [B, M, D] -> [K, H, M] float32. It has no
Pallas counterpart: the reference differentiates its jnp CIN in XLA.
The input gradients are K11 itself (`ops.CinLayer`); `cin_m_parts`
splits an x0 wider than the wide kernel's shared memory holds
(`CIN_MAX_M`).
"""
from __future__ import annotations

import torch

from . import _cuda

CIN_CHUNK_BYTES = 1 << 30   # one [b, D, H, M] outer product, at most
CIN_DTYPES = (torch.float32, torch.bfloat16)
_PLANS: dict[tuple, tuple] = {}  # `cin_plan` by (device, shapes, bf16)
# The widest x0 the wide K11 kernel takes: a block stages its 64 rows of
# x0 (64 * M words) beside 48,256 words of W, A and x1 stages and 2 * 64
# row offsets (`cin_smem_words` in csrc/cin_fuse.cu at M >= 32), in at
# most 232,448 bytes: 4 * (48,256 + 64 * M + 3 * 64 * 2) <= 232,448 gives
# M <= 148.
CIN_MAX_M = 148
# The most output channels the narrow K11 kernel takes (its accumulators:
# 2 rows x K / 4 a thread), for float32 inputs.
CIN_NARROW_MAX_K = 64
# K12 walks its contraction (n = b * D + d) in stages of this many n and
# cuts it into at most CIN_GRAD_MAX_SPLITS slices of whole stages, each
# summed by its own blocks into a workspace slice; a last launch adds the
# slices in index order. One block a tile of CIN_GRAD_TILE (r, k), one
# block an SM (its shared memory and registers).
CIN_GRAD_STAGE_N = 24
CIN_GRAD_TILE = (128, 200)
CIN_GRAD_MAX_SPLITS = 64
# The SM count a plan for a meta-tensor count assumes (`cin_scratch`,
# `cin_grad_scratch`): an H100 SXM's.
H100_SMS = 132
# The kernels' tilings, as csrc/cin_fuse.cu, cin_narrow.cu and
# cin_grad.cu define them, for the scratch a plan sizes without a card:
# the wide kernel's 64 rows n and 208 columns k a block, 32 r a stage and
# at most 8 r-axis splits; the narrow kernel's 40 h a stage and 8,000
# words a (stage, chunk) image, 25 // ceil(K / 8) values of m a chunk.
_CIN_BN, _CIN_BK, _CIN_RK, _CIN_MAX_SPLITS = 64, 208, 32, 8
_CN_SH, _CN_BWORDS = 40, 8000


def cin_chunk_rows(H: int, M: int, D: int, itemsize: int = 4) -> int:
    """Batch rows per chunk of the plain version: the most whose outer
    product fits `CIN_CHUNK_BYTES` (at least one)."""
    return max(1, CIN_CHUNK_BYTES // max(H * M * D * itemsize, 1))


def cin_shapes(x1, x0, w) -> tuple[int, int, int, int, int]:
    """(B, H, M, D, K) of a CIN layer's inputs; raises on a wrong rank or
    shapes that do not agree."""
    if x1.dim() != 3 or x0.dim() != 3 or w.dim() != 3:
        raise ValueError("cin_layer: expected x1 [B, H, D], x0 [B, M, D], "
                         "w [K, H, M]")
    B, H, D = x1.shape
    M = x0.shape[1]
    K = w.shape[0]
    if x0.shape != (B, M, D) or w.shape != (K, H, M):
        raise ValueError(f"cin_layer: shapes disagree: x1 {tuple(x1.shape)}"
                         f", x0 {tuple(x0.shape)}, w {tuple(w.shape)}")
    return B, H, M, D, K


def cin_layer_plain(x1, x0, w):
    """Plain version of K11: the sum in float32 (float64 where an input is
    float64: the CPU anchor of the smoke run uses that). Returns
    [B, K, D]."""
    B, H, M, D, K = cin_shapes(x1, x0, w)
    dt = torch.promote_types(torch.promote_types(x1.dtype, x0.dtype),
                             torch.promote_types(w.dtype, torch.float32))
    x1, x0, w = x1.to(dt), x0.to(dt), w.to(dt)
    wt = w.reshape(K, H * M).t()                          # [H*M, K]
    out = torch.empty((B, K, D), dtype=dt, device=x1.device)
    step = cin_chunk_rows(H, M, D, out.element_size())
    for a in range(0, B, step):
        xa, xb = x1[a:a + step].transpose(1, 2), x0[a:a + step].transpose(1, 2)
        n = xa.shape[0]
        z = xa[:, :, :, None] * xb[:, :, None, :]         # [n, D, H, M]
        out[a:a + step] = (z.reshape(n * D, H * M) @ wt).reshape(
            n, D, K).transpose(1, 2)
    return out


def cin_plan(device: torch.device, B: int, H: int, M: int, D: int, K: int,
             bf16: bool) -> tuple[int, int]:
    """(S, words) of K11 at these shapes on ``device``: the r-axis splits
    (1 unless the tile grid is smaller than the SM count) and the 32-bit
    words of the per-stage W images. Asked of the library once per
    shape."""
    key = (device.index, B, H, M, D, K, bf16)
    if key not in _PLANS:
        lib = _cuda.library("cin_fuse")
        with torch.cuda.device(device):
            s = lib.cin_layer_splits(B, H, M, D, K, int(bf16))
        if s < 1:
            _cuda.check_launch(-s, "cin_layer")
        _PLANS[key] = (s, lib.cin_layer_wimg_words(H, M, K))
    return _PLANS[key]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cin_splits_h100(B: int, H: int, M: int, D: int, K: int) -> int:
    """`cin_layer_splits` of csrc/cin_fuse.cu on `H100_SMS` SMs, one
    block an SM (the wide kernel's W buffers alone take 156 KB of an
    SM's 228 KB of shared memory)."""
    tiles = _cdiv(B * D, _CIN_BN) * _cdiv(K, _CIN_BK)
    stages = _cdiv(H * M, _CIN_RK)
    if tiles >= H100_SMS or stages < 2:
        return 1
    best, best_cost = 1, _cdiv(tiles, H100_SMS) * stages
    for s in range(2, min(_CIN_MAX_SPLITS, stages) + 1):
        per = _cdiv(stages, s)
        cost = _cdiv(tiles * _cdiv(stages, per), H100_SMS) * per
        if cost < best_cost:
            best, best_cost = s, cost
    per = _cdiv(stages, best)
    return _cdiv(stages, per)


def cin_scratch(device: torch.device, B: int, H: int, M: int, D: int,
                K: int, bf16: bool) -> tuple[tuple, int]:
    """The scratch a K11 call allocates beside its output: (the shape of
    its float32 workspace of r-axis splits, (S, B, K, D) where it splits
    and (0,) where not; the int32 words of its W images). The narrow
    kernel (`cin_narrow`) never splits. On a CUDA device the library's
    plan; on any other (a meta-tensor count) the same arithmetic here,
    for an H100 (`H100_SMS`)."""
    narrow = cin_narrow(K, torch.bfloat16 if bf16 else torch.float32)
    if device.type == "cuda":
        if narrow:
            return (0,), _cuda.library("cin_narrow").cin_narrow_wimg_words(
                H, M, K)
        S, words = cin_plan(device, B, H, M, D, K, bf16)
    elif narrow:
        kq = _cdiv(K, 8)
        S, words = 1, (_cdiv(H, _CN_SH) * _cdiv(M, 25 // kq) * 2
                       * _CN_BWORDS)
    else:
        S = _cin_splits_h100(B, H, M, D, K)
        words = (_cdiv(K, _CIN_BK) * _cdiv(H * M, _CIN_RK) * 2
                 * _CIN_RK * _CIN_BK)
    return ((S, B, K, D) if S > 1 else (0,)), words


def cin_narrow(K: int, dtype) -> bool:
    """Whether a K11 call with K output channels and inputs of ``dtype``
    goes to the narrow kernel on the card (float32, K <=
    `CIN_NARROW_MAX_K`); bfloat16 always goes to the wide kernel."""
    return dtype == torch.float32 and K <= CIN_NARROW_MAX_K


def cin_layer_cuda(x1, x0, w):
    """Launch K11 on the current stream. Narrow calls (`cin_narrow`) take
    the narrow kernel: w laid out as TF32 hi/lo images per (h stage, m
    chunk), then the factorized 3xTF32 wgmma kernel (two CUDA launches;
    scratch: the images); any M. Every other call takes the wide kernel:
    w laid out as per-stage TF32 hi/lo images, the 3xTF32 wgmma kernel
    and, where it splits the r axis over S blocks, the in-order sum of the
    S partial slices (two or three CUDA launches; scratch: the images and
    S * B * K * D floats); M at most `CIN_MAX_M`. x1, x0 and w all float32
    or all bfloat16, contiguous, on one CUDA device; any B. Returns
    [B, K, D] float32. A failure raises; no call falls back to the other
    kernel or to the plain version."""
    what = "cin_layer"
    B, H, M, D, K = cin_shapes(x1, x0, w)
    if not (x1.dtype == x0.dtype == w.dtype):
        raise TypeError(f"{what}: x1, x0 and w must share one dtype, got "
                        f"{x1.dtype}, {x0.dtype}, {w.dtype}")
    dts = {"x1": CIN_DTYPES, "x0": CIN_DTYPES, "w": CIN_DTYPES}
    _cuda.check_cuda_args(what, x1.device, dtypes=dts, x1=x1, x0=x0, w=w)
    out = torch.empty((B, K, D), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:                  # nothing to compute: no launch
        return out
    bf16 = x1.dtype == torch.bfloat16
    work_shape, words = cin_scratch(x1.device, B, H, M, D, K, bf16)
    wimg = torch.empty((words,), dtype=torch.int32, device=x1.device)
    if cin_narrow(K, x1.dtype):
        return _cin_narrow_launch(x1, x0, w, out, wimg, B, H, M, D, K)
    S = work_shape[0] if len(work_shape) > 1 else 1
    work = torch.empty(work_shape, dtype=torch.float32, device=x1.device)
    err = _cuda.library("cin_fuse").cin_layer_launch(
        x1.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
        work.data_ptr(), wimg.data_ptr(), B, H, M, D, K, int(bf16), S,
        _cuda.stream_ptr(x1.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def _cin_narrow_launch(x1, x0, w, out, wimg, B, H, M, D, K):
    """The narrow kernel's two launches into ``out`` (checked inputs)."""
    what = "cin_layer_narrow"
    err = _cuda.library("cin_narrow").cin_narrow_launch(
        x1.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
        wimg.data_ptr(), B, H, M, D, K, _cuda.stream_ptr(x1.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def cin_m_parts(M: int, narrow: bool = False) -> list[tuple[int, int]]:
    """x0's channels cut into the fewest near-equal [a, b) parts of at most
    `CIN_MAX_M` each (one part where M fits, or where the call is narrow:
    the narrow kernel takes any M): 200 -> (0, 100), (100, 200)."""
    if narrow:
        return [(0, M)]
    n = max(1, -(-M // CIN_MAX_M))
    return [(i * M // n, (i + 1) * M // n) for i in range(n)]


def cin_grad_shapes(g, x1, x0) -> tuple[int, int, int, int, int]:
    """(B, H, M, D, K) of a weight gradient's inputs; raises on a wrong
    rank or shapes that do not agree."""
    if g.dim() != 3 or x1.dim() != 3 or x0.dim() != 3:
        raise ValueError("cin_weight_grad: expected g [B, K, D], x1 "
                         "[B, H, D], x0 [B, M, D]")
    B, K, D = g.shape
    H, M = x1.shape[1], x0.shape[1]
    if x1.shape != (B, H, D) or x0.shape != (B, M, D):
        raise ValueError(f"cin_weight_grad: shapes disagree: g "
                         f"{tuple(g.shape)}, x1 {tuple(x1.shape)}, x0 "
                         f"{tuple(x0.shape)}")
    return B, H, M, D, K


def cin_weight_grad_plain(g, x1, x0):
    """Plain version of K12: the GEMM ``dw[k, r] = sum_n G[n, k] Z[n, r]``
    (n = b * D + d, r = h * M + m, Z the outer product of x1 and x0, as
    K11's plain version forms it), chunked over B so that Z stays under
    `CIN_CHUNK_BYTES`, the chunks added in order. float32 (float64 where
    an input is float64). Returns [K, H, M]."""
    B, H, M, D, K = cin_grad_shapes(g, x1, x0)
    dt = torch.promote_types(torch.promote_types(g.dtype, x1.dtype),
                             torch.promote_types(x0.dtype, torch.float32))
    g, x1, x0 = g.to(dt), x1.to(dt), x0.to(dt)
    out = torch.zeros((K, H * M), dtype=dt, device=g.device)
    step = cin_chunk_rows(H, M, D, out.element_size())
    for a in range(0, B, step):
        xa, xb = x1[a:a + step].transpose(1, 2), x0[a:a + step].transpose(1, 2)
        n = xa.shape[0]
        z = (xa[:, :, :, None] * xb[:, :, None, :]).reshape(n * D, H * M)
        gt = g[a:a + step].transpose(1, 2).reshape(n * D, K)
        out += gt.t() @ z
    return out.reshape(K, H, M)


def cin_grad_splits(B: int, H: int, M: int, D: int, K: int,
                    sms: int) -> int:
    """K12's contraction slices on a card of ``sms`` SMs: the count S <=
    `CIN_GRAD_MAX_SPLITS` with the least work on the busiest SM (waves x
    stages a slice; the fewest slices among equals), then S trimmed so
    that no slice is empty. One block a `CIN_GRAD_TILE` tile and a
    slice, one block an SM. 11 at train_batch and H = 39 (12 tiles: 132
    blocks, one full wave)."""
    stages = max(1, -(-(B * D) // CIN_GRAD_STAGE_N))
    tiles = -(-(H * M) // CIN_GRAD_TILE[0]) * -(-K // CIN_GRAD_TILE[1])
    best, best_cost = 1, -(-tiles // sms) * stages
    for s in range(2, min(CIN_GRAD_MAX_SPLITS, stages) + 1):
        per = -(-stages // s)
        cost = -(-(tiles * -(-stages // per)) // sms) * per
        if cost < best_cost:
            best, best_cost = s, cost
    per = -(-stages // best)
    return -(-stages // per)


def cin_grad_plan(device: torch.device, B: int, H: int, M: int, D: int,
                  K: int) -> int:
    """`cin_grad_splits` at these shapes on ``device``'s SM count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return cin_grad_splits(B, H, M, D, K, sms)


def cin_grad_scratch(device: torch.device, B: int, H: int, M: int,
                     D: int, K: int) -> tuple[tuple, int]:
    """The scratch a K12 call allocates beside its output: (the shape of
    its float32 workspace of slices, (S, K, H, M) where S > 1 and (0,)
    where not; the int32 words of its G images). On a CUDA device S comes
    from its SM count and the words from the library; on any other (a
    meta-tensor count) S is that of `H100_SMS` and the words are
    computed here."""
    if device.type == "cuda":
        S = cin_grad_plan(device, B, H, M, D, K)
        words = _cuda.library("cin_grad").cin_weight_grad_gimg_words(B, D, K)
    else:
        S = cin_grad_splits(B, H, M, D, K, H100_SMS)
        words = (max(1, _cdiv(B * D, CIN_GRAD_STAGE_N))
                 * _cdiv(K, CIN_GRAD_TILE[1]) * 2 * CIN_GRAD_STAGE_N
                 * CIN_GRAD_TILE[1])
    return ((S, K, H, M) if S > 1 else (0,)), words


def cin_weight_grad_cuda(g, x1, x0):
    """Launch K12 on the current stream: g laid out as per-stage TF32
    hi/lo images, the 3xTF32 wgmma GEMM over the contraction's slices
    into an fp32 workspace, then (where there is more than one slice) the
    in-order sum of the slices (two or three CUDA launches). Scratch: the
    images (2 * B * D * 200 words a 200-column block of K, rounded up to
    a stage) and S * K * H * M floats, S = `cin_grad_plan`. g, x1 and x0
    float32, contiguous, on one CUDA device; any B. Returns [K, H, M]
    float32. A failure raises; nothing falls back to the plain version."""
    what = "cin_weight_grad"
    B, H, M, D, K = cin_grad_shapes(g, x1, x0)
    dts = {"g": torch.float32, "x1": torch.float32, "x0": torch.float32}
    _cuda.check_cuda_args(what, g.device, dtypes=dts, g=g, x1=x1, x0=x0)
    out = torch.empty((K, H, M), dtype=torch.float32, device=g.device)
    if out.numel() == 0:                  # nothing to compute: no launch
        return out
    work_shape, words = cin_grad_scratch(g.device, B, H, M, D, K)
    S = work_shape[0] if len(work_shape) > 1 else 1
    work = torch.empty(work_shape, dtype=torch.float32, device=g.device)
    gimg = torch.empty((words,), dtype=torch.int32, device=g.device)
    err = _cuda.library("cin_grad").cin_weight_grad_launch(
        g.data_ptr(), x1.data_ptr(), x0.data_ptr(), out.data_ptr(),
        work.data_ptr(), gimg.data_ptr(), B, H, M, D, K, S,
        _cuda.stream_ptr(g.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out
