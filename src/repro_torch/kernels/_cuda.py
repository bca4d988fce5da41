"""Build, load and launch bookkeeping for the port's CUDA kernels.

Each source in `repro_torch/csrc/` is compiled by `nvcc` into a shared
library with a plain C interface and loaded with `ctypes`. The build runs
at first use, from the sources in the checkout only, into `build/` at the
repository root; the library's file name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: CPU-only hosts import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("wcsd_query", "frontier", "cin_fuse", "cin_narrow", "cin_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, and nowhere else (the smoke run resets and reads these)
LAUNCHES = {"wcsd_query_ragged": 0, "wcsd_profile_ragged": 0,
            "wc_prune_emit_batched": 0, "wc_relax_batched": 0,
            "wcsd_query_ragged_compressed": 0,
            "wcsd_profile_ragged_compressed": 0,
            "wcsd_query_segmented": 0, "wcsd_profile_segmented": 0,
            "wcsd_query_gathered": 0, "frontier_relax_gathered": 0,
            "cin_layer": 0, "cin_layer_narrow": 0, "cin_weight_grad": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C prototype of every exported function, by source: set once when
# `library` loads the source's library (pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints); each returns an int
# (a launcher's cudaError_t) unless `RESTYPES` names another type
PROTOTYPES = {
    "wcsd_query": {
        "wcsd_query_ragged_launch": [_P] * 10 + [_LL, _I, _P],
        "wcsd_profile_ragged_launch": [_P] * 9 + [_LL, _I, _I, _P],
        "wcsd_query_ragged_compressed_launch": [_P] * 10 + [_LL, _I, _I,
                                                            _P],
        "wcsd_profile_ragged_compressed_launch": [_P] * 9 + [_LL, _I, _I,
                                                             _I, _P],
        "wcsd_query_segmented_launch": [_P] * 10 + [_LL, _I, _I, _P],
        "wcsd_query_segmented_grouped_launch": [_P, _I] + [_P] * 4
        + [_LL, _I, _I, _P],
        "wcsd_profile_segmented_launch": [_P] * 9 + [_LL, _I, _I, _I, _P],
        "wcsd_profile_segmented_grouped_launch": [_P, _I] + [_P] * 3
        + [_LL, _I, _I, _I, _P],
        "wcsd_query_gathered_launch": [_P] * 5 + [_LL, _I, _P],
    },
    "frontier": {
        "wc_prune_emit_launch": [_P] * 7 + [_I] * 5 + [_P],
        "wc_relax_batched_launch": [_P] * 10 + [_I] * 3 + [_P],
        "frontier_relax_gathered_launch": [_P] * 5 + [_I] * 2 + [_P],
    },
    "cin_fuse": {
        "cin_layer_splits": [_I] * 6,
        "cin_layer_wimg_words": [_I] * 3,
        "cin_layer_launch": [_P] * 6 + [_I] * 7 + [_P],
    },
    "cin_narrow": {
        "cin_narrow_wimg_words": [_I] * 3,
        "cin_narrow_launch": [_P] * 5 + [_I] * 5 + [_P],
    },
    "cin_grad": {
        "cin_weight_grad_gimg_words": [_I] * 3,
        "cin_weight_grad_launch": [_P] * 6 + [_I] * 6 + [_P],
    },
}
RESTYPES = {"cin_layer_wimg_words": _LL, "cin_narrow_wimg_words": _LL,
            "cin_weight_grad_gimg_words": _LL}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    """A port kernel did not build, load or launch. Not a transient engine
    fault: the server re-raises it instead of retrying or demoting, so a
    broken kernel is never hidden behind a plain rung of the ladder."""


# failures the server's watchdog must not absorb: a kernel that does not
# build, load or launch, and a CUDA error, which leaves the context
# unusable for every rung alike
NOT_RETRYABLE = (KernelError,) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the port's CUDA "
                          "kernels are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(names=SOURCES) -> None:
    """Compile every named source that has no up-to-date library, one
    `nvcc` per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log.decode()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise KernelError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, its
    launchers' prototypes set (`PROTOTYPES`)."""
    with _lock:
        if name not in _libs:
            build((name,))
            try:
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn, argtypes in PROTOTYPES[name].items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = RESTYPES.get(fn, ctypes.c_int)
            except (OSError, AttributeError) as err:
                raise KernelError(f"loading {name}.cu's library: {err}") \
                    from err
            _libs[name] = lib
        return _libs[name]


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_args(what: str, device: torch.device, *,
                    dtypes: dict | None = None, **tensors) -> None:
    """Validate the tensors a kernel takes: same CUDA device, contiguous,
    and of the expected dtype -- int32 unless ``dtypes`` names another
    (or a tuple of accepted ones) for that tensor. The kernels index flat
    memory and take no strides."""
    if device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{device}")
    dtypes = dtypes or {}
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{what}: {name} is on {x.device}, expected "
                             f"{device}")
        want = dtypes.get(name, torch.int32)
        want = want if isinstance(want, tuple) else (want,)
        if x.dtype not in want:
            raise TypeError(f"{what}: {name} must be "
                            f"{' or '.join(str(w) for w in want)}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card. Asking
    for the card where there is none raises — the port never falls back
    to the CPU on its own; tests pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
