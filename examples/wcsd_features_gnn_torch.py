"""The paper's technique as a feature pipeline, on the PyTorch/CUDA port
(`repro_torch`), as `examples/wcsd_features_gnn.py` does with the JAX
package: WC-INDEX quality-constrained distance encodings feed a GIN node
classifier.

Labels depend on quality-constrained proximity to two "hub" vertices, so
the WC-INDEX features carry real signal: the model with distance
encodings should beat the bare-feature model. The encodings come from
`data.graphs.distance_encoding`, which answers its queries through the
device engine (K1, the ragged query kernel, one launch a flush on the
card); the GIN trains through the port's train step (AdamW).

    python examples/wcsd_features_gnn_torch.py                # on the card
    python examples/wcsd_features_gnn_torch.py --device cpu   # plain
                                                              # versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import build_wc_index
from repro_torch.core.generators import scale_free
from repro_torch.data.graphs import distance_encoding
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models import gnn
from repro_torch.train import optim as O
from repro_torch.train.loop import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    ap.add_argument("--nodes", type=int, default=600,
                    help="graph size (the CPU test cuts it)")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = scale_free(args.nodes, 3, num_levels=4, seed=0)
    idx = build_wc_index(g)
    rng = np.random.default_rng(0)
    nodes = np.arange(g.num_nodes)

    # labels: is the vertex within quality-2 distance 3 of either hub?
    hubs = np.array([0, 1])
    d = distance_encoding(idx, nodes, hubs, w_levels=[2], device=dev)
    labels = (d.min(axis=1) <= 3).astype(np.int32)
    print(f"label balance: {labels.mean():.2f}")

    base_feat = rng.standard_normal((g.num_nodes, 8)).astype(np.float32)
    enc = distance_encoding(idx, nodes, hubs, w_levels=[0, 2], device=dev)
    enc = (enc - enc.mean(0)) / (enc.std(0) + 1e-6)  # standardize

    def run(feat, name):
        cfg = gnn.GNNConfig(name, "gin", n_layers=3, d_hidden=32,
                            d_feat=feat.shape[1], n_classes=2)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        params = gnn.init_params(cfg, gen)
        ocfg = O.OptimizerConfig(lr=2e-3, warmup_steps=10,
                                 total_steps=args.steps, weight_decay=0.0)
        opt = O.init_opt_state(ocfg, params)
        batch = {"feat": torch.from_numpy(feat).to(dev),
                 "edges_src": torch.from_numpy(g.edges_src).to(dev),
                 "edges_dst": torch.from_numpy(g.edges_dst).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        step = make_train_step(lambda p, b: gnn.loss_fn(p, cfg, b), ocfg)
        for _ in range(args.steps):
            params, opt, m = step(params, opt, batch)
        with torch.no_grad():
            logits = gnn.forward(params, cfg, batch)
        acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
        print(f"{name:28s} final loss {float(m['loss']):.3f} acc {acc:.3f}")
        return acc

    acc_base = run(base_feat, "bare features")
    acc_wcsd = run(np.concatenate([base_feat, enc], 1),
                   "+ WC-INDEX distance encodings")
    assert acc_wcsd > acc_base
    print("WC-INDEX features improve the GNN — the paper's index as a "
          "data-pipeline stage.")
    return {"acc_base": acc_base, "acc_wcsd": acc_wcsd,
            "labels": labels, "encodings": enc}


if __name__ == "__main__":
    main()
