"""The xDeepFM CIN layer, K11 (the reference's `kernels/cin_fuse.py:
cin_layer`): its CUDA launcher and, beside it, its plain PyTorch version.

    out[b, k, d] = sum_{h, m} w[k, h, m] * x1[b, h, d] * x0[b, m, d]

x1 [B, H, D], x0 [B, M, D], w [K, H, M] -> [B, K, D] float32. The CUDA
source is `repro_torch/csrc/cin_fuse.cu` (3xTF32 on the tensor cores).
The plain version translates the reference's `kernels/ref.py:
cin_layer_ref`, in the TPU kernel's form (the outer product z as a
[b*D, H*M] matrix against w as [H*M, K]), chunked over B so that z
stays under `CIN_CHUNK_BYTES`: unchunked it would be B*H*M*D floats,
81.8 GB at B = 262,144 and the model's widths.
"""
from __future__ import annotations

import torch

from . import _cuda

CIN_CHUNK_BYTES = 1 << 30   # one [b, D, H, M] outer product, at most
CIN_DTYPES = (torch.float32, torch.bfloat16)
_PLANS: dict[tuple, tuple] = {}  # `cin_plan` by (device, shapes, bf16)


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


def cin_layer_cuda(x1, x0, w):
    """Launch K11 on the current stream: w laid out as per-stage TF32
    hi/lo images, the 3xTF32 wgmma kernel and, where it splits the r axis
    over S blocks, the in-order sum of the S partial slices (two or three
    CUDA launches; scratch: the images and S * B * K * D floats). x1, x0
    and w all float32 or all bfloat16, contiguous, on one CUDA device; any
    B. Returns [B, K, D] float32."""
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
    S, words = cin_plan(x1.device, B, H, M, D, K, bf16)
    work = torch.empty((S, B, K, D) if S > 1 else (0,), dtype=torch.float32,
                       device=x1.device)
    wimg = torch.empty((words,), dtype=torch.int32, device=x1.device)
    err = _cuda.library("cin_fuse").cin_layer_launch(
        x1.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
        work.data_ptr(), wimg.data_ptr(), B, H, M, D, K, int(bf16), S,
        _cuda.stream_ptr(x1.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out
