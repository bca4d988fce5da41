"""The port stands alone: `repro_torch` (the GNN and LM families included),
`chip_smoke.py`, the `scripts/chip_*.py` harnesses and the port's
examples import neither `jax` nor the reference package `repro`; entry
points default to the card and raise where there is none; the CUDA
launchers refuse CPU tensors (K11's also mixed dtypes and wrong ranks);
and the engine configurations the reference refuses raise
`ValueError`."""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_import_every_module_without_jax_or_repro():
    mods = _port_modules()
    assert len(mods) >= 49, mods
    for m in ("repro_torch.checkpoint.fault", "repro_torch.models.xdeepfm",
              "repro_torch.models.common", "repro_torch.data.recsys",
              "repro_torch.configs.xdeepfm_arch",
              "repro_torch.kernels.cin_fuse", "repro_torch.launch",
              "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
              "repro_torch.distributed",
              "repro_torch.distributed.collectives",
              "repro_torch.distributed.pipeline",
              "repro_torch.configs.wcsd_serve", "repro_torch.train",
              "repro_torch.train.optim", "repro_torch.train.loop",
              "repro_torch.train.grad_compress", "repro_torch.train.tree",
              "repro_torch.models.gnn", "repro_torch.models.nequip",
              "repro_torch.models.segment_mesh",
              "repro_torch.data.graphs", "repro_torch.configs.gnn_common",
              "repro_torch.configs.gin_tu", "repro_torch.configs.pna",
              "repro_torch.configs.gatedgcn",
              "repro_torch.configs.nequip", "repro_torch.data.lm",
              "repro_torch.models.attention", "repro_torch.models.moe",
              "repro_torch.models.transformer",
              "repro_torch.configs.lm_common",
              "repro_torch.configs.llama3_8b",
              "repro_torch.configs.qwen2_moe_a2_7b",
              "repro_torch.configs.dbrx_132b",
              "repro_torch.configs.qwen25_14b",
              "repro_torch.configs.codeqwen15_7b",
              "repro_torch.configs.cell", "repro_torch.launch.op_analysis",
              "repro_torch.launch.roofline"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


_BANNED = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"from\s+repro(\.|\s)|import\s+repro(\.|\s|$))", re.M)


def test_source_scan_finds_no_jax_or_repro_import():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "chip_ab.py"),
             os.path.join(REPO, "scripts", "chip_mesh.py"),
             os.path.join(REPO, "scripts", "chip_gnn.py"),
             os.path.join(REPO, "scripts", "chip_cin_ab.py"),
             os.path.join(REPO, "scripts", "chip_gather_ab.py"),
             os.path.join(REPO, "scripts", "chip_lm.py"),
             os.path.join(REPO, "scripts", "chip_dryrun.py"),
             os.path.join(REPO, "scripts", "chip_lm_mesh.py"),
             os.path.join(REPO, "scripts", "chip_gnn_mesh.py"),
             os.path.join(REPO, "examples", "quickstart_torch.py"),
             os.path.join(REPO, "examples", "serve_wcsd_torch.py"),
             os.path.join(REPO, "examples", "wcsd_features_gnn_torch.py"),
             os.path.join(REPO, "examples", "train_lm_torch.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 50
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not _BANNED.search(text), path
    # the pattern does catch the reference package, and spares the port
    assert _BANNED.search("from repro.core import graph")
    assert _BANNED.search("import repro.kernels.ops")
    assert _BANNED.search("import jax.numpy as jnp")
    assert not _BANNED.search("from repro_torch.core import graph")
    assert not _BANNED.search("import repro_torch")


def _tiny():
    from repro_torch.core.generators import erdos_renyi
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    g = erdos_renyi(12, 2.0, num_levels=2, seed=0)
    idx, _ = build_wc_index_batched_packed(g, device="cpu")
    return g, idx


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.core.query import DeviceQueryEngine
    from repro_torch.core.serve import WCSDServer
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    g, idx = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_wc_index_batched_packed(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryEngine(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WCSDServer(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WCSDServer(idx, device="cuda")
    from repro_torch.core.query import ShardedQueryEngine
    from repro_torch.launch.mesh import make_serving_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedQueryEngine(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WCSDServer(idx, backend="sharded")
    from repro_torch.configs.xdeepfm_arch import smoke_config
    from repro_torch.models.xdeepfm import XDeepFM
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XDeepFM(smoke_config())
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import distance_encoding
    from repro_torch.models.gnn import GNN
    from repro_torch.models.nequip import NequIP
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNN(get_arch("gin-tu").smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NequIP(get_arch("nequip").smoke_config())
    # the encodings go through the engine on the card: no numpy fallback
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distance_encoding(idx, np.arange(4), np.array([0]), [0])
    from repro_torch.models import transformer as T
    for arch in ("llama3-8b", "qwen2-moe-a2.7b"):
        cfg = get_arch(arch).smoke_config()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.LM(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.LM(cfg, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.params_from_numpy(cfg, T.params_to_numpy(T.LM(cfg, "cpu")))
    from repro_torch.distributed.pipeline import gpipe_forward
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpipe_forward(None, torch.zeros(2, 4, 4), torch.zeros(3, 2, 4))
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", os.path.join(REPO, "examples", "train_lm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--steps", "1", "--d-model", "16", "--layers", "1"])


def test_cuda_launchers_refuse_cpu_tensors():
    """A launcher never runs the plain version: given CPU tensors it
    raises before any build or launch."""
    from repro_torch.kernels import frontier as kfr
    from repro_torch.kernels import wcsd_query as kwq
    z = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kwq.wcsd_query_ragged_cuda(z, z, z, v, v, v, v, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        kwq.wcsd_profile_ragged_cuda(z, z, z, v, v, v, v, v, 5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kfr.wc_prune_emit_batched_cuda(z, torch.zeros((4, 8, 3),
                                                      dtype=torch.int32),
                                       z, z, z, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kfr.wc_relax_batched_cuda(z, z, z, torch.zeros(8, dtype=torch.int32),
                                  v, z)
    from repro_torch.kernels import wcsd_segmented as kseg
    h16 = torch.zeros((4, 8), dtype=torch.int16)
    d16 = torch.zeros((4, 8), dtype=torch.bfloat16)
    w8 = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kwq.wcsd_query_ragged_compressed_cuda(h16, d16, w8, v, v, v, v, v,
                                              v)
    with pytest.raises(ValueError, match="CUDA"):
        kwq.wcsd_profile_ragged_compressed_cuda(h16, d16, w8, v, v, v, v, v,
                                                5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kseg.wcsd_query_segmented_cuda(z, z, z, z, z, z, v, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        kseg.wcsd_profile_segmented_cuda(z, z, z, z, z, z, v, v, 3)
    flush = kseg.GroupedFlush([((z, z, z), (z, z, z), 4)],
                              torch.zeros((3, 4), dtype=torch.int32), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kseg.wcsd_query_segmented_grouped_cuda(flush)
    with pytest.raises(ValueError, match="CUDA"):
        kseg.wcsd_profile_segmented_grouped_cuda(flush, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kwq.wcsd_query_gathered_cuda(z, z, z, z)
    with pytest.raises(ValueError, match="CUDA"):
        kfr.frontier_relax_gathered_cuda(z, z, v)
    from repro_torch.kernels import cin_fuse as kcin
    with pytest.raises(ValueError, match="CUDA"):
        kcin.cin_layer_cuda(torch.zeros((4, 3, 2)), torch.zeros((4, 5, 2)),
                            torch.zeros((6, 3, 5)))


def test_cin_launcher_refuses_mixed_dtypes_and_wrong_shapes():
    """K11 takes x1/x0/w all float32 or all bfloat16, of ranks 3 and
    agreeing shapes; anything else raises before any build or launch."""
    from repro_torch.kernels import cin_fuse as kcin
    x1, x0, w = torch.zeros((4, 3, 2)), torch.zeros((4, 5, 2)), \
        torch.zeros((6, 3, 5))
    with pytest.raises(TypeError, match="one dtype"):
        kcin.cin_layer_cuda(x1.bfloat16(), x0, w)
    with pytest.raises(TypeError, match="one dtype"):
        kcin.cin_layer_cuda(x1, x0, w.double())
    with pytest.raises(ValueError, match="expected x1"):
        kcin.cin_layer_cuda(x1[0], x0, w)
    with pytest.raises(ValueError, match="disagree"):
        kcin.cin_layer_cuda(x1, x0[:, :4], w)


def test_cuda_arg_checks_take_a_dtype_per_tensor():
    """`check_cuda_args` holds each tensor to its own dtype (int32 unless
    named): the compressed kernels take int16 / bf16 or fp16 / int8."""
    from repro_torch.kernels._cuda import check_cuda_args
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        check_cuda_args("k", meta, x=torch.zeros(2, device=meta))
    # the dtype checks, reached through a stand-in device object
    dev = torch.device("cuda", 0)

    class Fake:
        def __init__(self, dtype):
            self.device, self.dtype = dev, dtype

        def is_contiguous(self):
            return True

    check_cuda_args("k", dev, dtypes={"d": (torch.bfloat16, torch.float16)},
                    a=Fake(torch.int32), d=Fake(torch.float16))
    with pytest.raises(TypeError, match="int32"):
        check_cuda_args("k", dev, a=Fake(torch.int16))
    with pytest.raises(TypeError, match="bfloat16"):
        check_cuda_args("k", dev, dtypes={"d": (torch.bfloat16,
                                                torch.float16)},
                        d=Fake(torch.float32))


def test_wrappers_choose_by_device():
    """ops wrappers: CPU tensors take the plain version (no launch is
    counted); a device that is neither CPU nor CUDA is refused, but for
    meta tensors on the dry run's wrappers (`cin_layer` here), which
    give a meta result of the right shape and launch nothing."""
    from repro_torch.kernels import _cuda, ops
    F = torch.full((2, 5), -1, dtype=torch.int32)
    rank = torch.arange(5, dtype=torch.int32)
    nbr = torch.full((5, 2), -1, dtype=torch.int32)
    _cuda.reset_launch_counts()
    newF, newR = ops.wc_relax_batched(F, nbr, nbr, rank,
                                      torch.zeros(2, dtype=torch.int32), F)
    assert (newF == -1).all() and (newR == -1).all()
    assert sum(_cuda.LAUNCHES.values()) == 0
    meta = torch.empty((2, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.wc_relax_batched(meta, nbr, nbr, rank, rank, meta)
    x1, x0, w = torch.ones((2, 3, 4)), torch.ones((2, 5, 4)), \
        torch.ones((6, 3, 5))
    out = ops.cin_layer(x1, x0, w)
    assert out.shape == (2, 6, 4) and (out == 15).all()
    assert sum(_cuda.LAUNCHES.values()) == 0
    out = ops.cin_layer(x1.to("meta"), x0.to("meta"), w.to("meta"))
    assert out.is_meta and out.shape == (2, 6, 4)
    assert out.dtype == torch.float32
    assert sum(_cuda.LAUNCHES.values()) == 0


def test_unported_engine_features_raise():
    """The padded layout is ported and builds; ``cap`` and
    ``use_pallas=False`` with the CSR layout raise `ValueError`;
    bucket-pair dispatch and the compressed arena are ported, but not
    together (as in the reference); the sharded backend serves over a
    mesh of CPU shards, and ``graph=`` and ``wal_path=`` (the
    dynamic index and the update WAL) build."""
    from repro_torch.core.query import DeviceQueryEngine
    from repro_torch.core.serve import WCSDServer
    g, idx = _tiny()
    eng = DeviceQueryEngine(idx, device="cpu", layout="padded")
    assert eng.dispatch == "dense" and eng.use_pallas
    assert eng.hub.shape[1] % 128 == 0        # lane pad for the kernel
    plain = DeviceQueryEngine(idx, device="cpu", layout="padded",
                              use_pallas=False, cap=2)
    assert plain.hub.shape[1] == 2
    assert DeviceQueryEngine(idx, device="cpu",
                             dispatch="bucket_pair").dispatch == "bucket_pair"
    assert DeviceQueryEngine(idx, device="cpu", compressed=True).compressed
    with pytest.raises(ValueError, match="compressed"):
        DeviceQueryEngine(idx, device="cpu", dispatch="bucket_pair",
                          compressed=True)
    with pytest.raises(ValueError, match="compressed"):
        DeviceQueryEngine(idx, device="cpu", layout="padded",
                          compressed=True)
    with pytest.raises(ValueError, match="dispatch"):
        DeviceQueryEngine(idx, device="cpu", dispatch="dense")
    with pytest.raises(ValueError, match="layout"):
        DeviceQueryEngine(idx, device="cpu", layout="arena")
    with pytest.raises(ValueError, match="cap"):
        DeviceQueryEngine(idx, device="cpu", cap=4)
    with pytest.raises(ValueError, match="use_pallas"):
        DeviceQueryEngine(idx, device="cpu", use_pallas=False)
    from repro_torch.launch.mesh import make_serving_mesh
    srv = WCSDServer(idx, backend="sharded", device="cpu",
                     mesh=make_serving_mesh([torch.device("cpu")] * 8))
    assert srv.engine.ndev == 8
    assert srv.query_many([0, 3], [5, 3], [0, 1])[1] == 0
    assert WCSDServer(idx, device="cpu", graph=g).graph_version == 0


def test_kernel_library_is_keyed_on_its_source():
    """The build writes `build/lib<name>_<hash>.so` at the repo root; the
    hash covers the source and the nvcc flags."""
    from repro_torch.kernels import _cuda
    p = _cuda._lib_path("wcsd_query")
    assert p.parent == _cuda.BUILD_DIR
    assert os.path.samefile(_cuda.BUILD_DIR.parent, REPO)
    assert p.name.startswith("libwcsd_query_") and p.suffix == ".so"
    assert p != _cuda._lib_path("frontier")
    assert _cuda._lib_path("cin_fuse").name.startswith("libcin_fuse_")
    assert "cin_fuse" in _cuda.SOURCES and "cin_layer" in _cuda.LAUNCHES
    assert "sm_90a" in " ".join(_cuda.NVCC_FLAGS)


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result where there is
    no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_resolve_device():
    from repro_torch.kernels._cuda import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
