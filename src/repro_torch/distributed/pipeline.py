"""GPipe-style pipeline parallelism over a mesh's "pod" axis, the
reference package's `distributed/pipeline.py`.

Each stage holds one block of layers and sits on the device of its
"pod" coordinate (the shard whose other coordinates are 0). Microbatches
stream through the stages on the classic (M + S - 1)-tick schedule: at
tick t stage s runs microbatch t - s. The reference runs every stage at
every tick under `shard_map` and writes only the valid ones; the port's
single controller issues only the valid (stage, microbatch) pairs, the
bubble's ticks doing nothing on the stages they idle. The stage boundary
(``.to`` the next stage's device, the reference's `ppermute`) is the
only cross-stage traffic; the stages' work is queued on their own
devices with no host sync, so the devices overlap as the schedule lets
them.
"""
from __future__ import annotations

import torch

from ..launch.mesh import ServingMesh, make_serving_mesh


def _stage_devices(mesh, axis: str) -> list:
    """The device of each stage: the shard at that coordinate of
    ``axis`` and coordinate 0 on every other axis."""
    S = mesh.axis_size(axis)
    devs = [None] * S
    for k in range(mesh.size):
        c = mesh.coords(k)
        if all(v == 0 for a, v in c.items() if a != axis) \
                and devs[c[axis]] is None:
            devs[c[axis]] = mesh.devices[k]
    return devs


def gpipe_forward(mesh, stage_weights, microbatches, n_microbatches=None,
                  stage_fn=None, axis: str = "pod"):
    """Run microbatches through a pipeline of stages.

    mesh: a `launch.mesh.ServingMesh` with the axis ``axis``; None means
      every visible card as one "pod" axis (it raises where there is
      none).
    stage_weights: [S, ...] (stage s's weights at index s) or a list of
      S tensors; each stage's weights are moved to its device once.
    microbatches: [M, b, d]. n_microbatches: the reference's argument;
      where given it must equal M.
    stage_fn: ``(w, x) -> x``, default ``tanh(x @ w)``.
    Returns the last stage's outputs [M, b, d], on its device."""
    if mesh is None:
        cards = make_serving_mesh()
        mesh = ServingMesh(cards.devices, (axis,), (cards.size,))
    S = mesh.axis_size(axis)
    M = microbatches.shape[0]
    if n_microbatches is not None and n_microbatches != M:
        raise ValueError(f"n_microbatches={n_microbatches} but "
                         f"{M} microbatches were given")
    if len(stage_weights) != S:
        raise ValueError(f"{len(stage_weights)} stage weights for {S} "
                         f"stages of axis {axis!r}")
    if stage_fn is None:
        stage_fn = lambda w, x: torch.tanh(x @ w)   # noqa: E731
    devs = _stage_devices(mesh, axis)
    ws = [stage_weights[s].to(devs[s]) for s in range(S)]
    xs = microbatches.to(devs[0])
    recv = [None] * S          # recv[s]: the input stage s runs next
    outputs = [None] * M
    for t in range(M + S - 1):
        # last stage first, so each stage reads what its predecessor
        # sent in the tick before
        for s in reversed(range(S)):
            i = t - s
            if not 0 <= i < M:
                continue
            out = stage_fn(ws[s], xs[i] if s == 0 else recv[s])
            if s == S - 1:
                outputs[i] = out
            else:
                recv[s + 1] = out.to(devs[s + 1])
    return torch.stack(outputs)


def pipeline_bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
