"""End-to-end LM training on the PyTorch/CUDA port (`repro_torch`), as
`examples/train_lm.py` does with the JAX package: a llama-style LM on the
synthetic `TokenStream`, AdamW with warmup-cosine, checkpoints, and the
fault-tolerant runner (a failure is injected half way to show the
restart).

    python examples/train_lm_torch.py                # on the card
    python examples/train_lm_torch.py --device cpu   # plain PyTorch

`main(argv, init=None)` returns the runner's log; ``init`` is an optional
nested dict of numpy arrays to start from (the reference's
`init_params`, carried across) instead of the port's seeded init.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.checkpoint.fault import FaultTolerantRunner
from repro_torch.data.lm import TokenStream
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import param_tree
from repro_torch.train import optim as O
from repro_torch.train.loop import make_train_step


def make_config(d_model: int, layers: int) -> T.LMConfig:
    return T.LMConfig(
        name="lm-example", n_layers=layers, d_model=d_model,
        n_heads=8, n_kv_heads=4, d_ff=4 * d_model, vocab=32000,
        d_head=d_model // 8, tp_size=1)


def main(argv=None, init=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_config(args.d_model, args.layers)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params on {dev}")
    model = (T.LM(cfg, device=dev, seed=0) if init is None
             else T.params_from_numpy(cfg, init, device=dev))
    params = param_tree(model)
    ocfg = O.OptimizerConfig(lr=args.lr, warmup_steps=20,
                             total_steps=args.steps)
    opt = O.init_opt_state(ocfg, params)
    step = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), ocfg)

    stream = TokenStream(cfg.vocab, args.seq, args.batch, seed=0)

    def batch_for_step(s):
        stream.set_cursor(s)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.next_batch().items()}

    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        runner = FaultTolerantRunner(
            step, params, opt, CheckpointManager(ckpt_dir),
            ckpt_every=25,
            failure_schedule={args.steps // 2:
                              RuntimeError("injected failure")})
        log = runner.run(None, max_steps=args.steps,
                         batch_for_step=batch_for_step)

    steps = [r for r in log if r["event"] == "step"]
    fails = [r for r in log if r["event"] == "failure"]
    print(f"ran {len(steps)} steps ({len(fails)} failure(s) survived, "
          f"{runner.restarts} restart(s))")
    print(f"loss: {steps[0]['loss']:.3f} -> {steps[-1]['loss']:.3f}")
    print(f"mean step time "
          f"{sum(s['time_s'] for s in steps) / len(steps):.3f}s")
    assert steps[-1]["loss"] < steps[0]["loss"]
    return log


if __name__ == "__main__":
    main()
