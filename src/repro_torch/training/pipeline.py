"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

The JAX package's ``training/pipeline.py``, single-controller. Each of the
S pipeline stages owns a contiguous slice of layers (the stacked parameters
split over ``pipe`` on their leading layer axis), held on its mesh
position's device. A microbatched forward runs the GPipe schedule: at tick
t, stage s processes microbatch t − s, and its activation moves to stage
s + 1's device for tick t + 1 (the reference's ``ppermute`` ring). Over
``n_micro + S − 1`` ticks the last stage emits microbatch t − (S − 1).

Where the reference's stages compute every tick (a bubble tick runs on a
clamped microbatch or a zero buffer, and its result is dropped), the port's
skip the ticks whose result would be dropped; the outputs are the same.
Only the last stage's outputs are returned, on its device, where the
reference broadcasts them to every stage with a masked ``psum``.

Under an active cost recorder (``repro_torch.launch.cost``) each stage's
work is charged to its position, and the stage slices of the parameters
and the hand-offs to the next stage as point-to-point moves
(``collective-permute``, the reference's ``ppermute``).
"""
from __future__ import annotations

import torch

from repro_torch.launch import cost


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def gpipe_forward(layer_fn, stacked_params, x: torch.Tensor, *, mesh, axis: str = "pipe") -> torch.Tensor:
    """Run ``layer_fn(params_slice, h)`` through S pipeline stages.

    ``stacked_params``: a tree (dicts, lists, tuples) of tensors with a
    leading (n_layers,) axis, n_layers % S == 0; stage s owns layers
    [s·L/S, (s+1)·L/S) on the device at position s of ``axis`` (index 0 on
    every other axis). ``x``: (n_micro, micro_batch, ...), n_micro >= S.
    Returns the (n_micro, micro_batch, ...) outputs on the last stage's
    device."""
    S = mesh.shape[axis]
    n_micro = x.shape[0]
    if n_micro < S:
        raise ValueError(f"{n_micro} microbatches for {S} stages")
    L = _leaves(stacked_params)[0].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not split over {S} stages")
    per = L // S
    devices = mesh.devices.transpose(
        [mesh.axis_names.index(axis)] + [i for i, a in enumerate(mesh.axis_names) if a != axis]
    ).reshape(S, -1)[:, 0]
    stages = [_tree_map(lambda t, s=s: t[s * per:(s + 1) * per].to(devices[s]), stacked_params) for s in range(S)]
    for s in range(1, S):
        nb = sum(t.numel() * t.element_size() for t in _leaves(stages[s]))
        cost.collective("collective-permute", nb, nb)

    def run_stage(s: int, h: torch.Tensor) -> torch.Tensor:
        with cost.at((s,)):
            for i in range(per):
                h = layer_fn(_tree_map(lambda t: t[i], stages[s]), h)
        return h

    outs = [None] * n_micro
    buf = [None] * S  # the activation each stage receives for this tick
    for t in range(n_micro + S - 1):
        nxt = [None] * S
        for s in range(S):
            mb = t - s  # the microbatch stage s processes at tick t
            if not 0 <= mb < n_micro:
                continue
            h = run_stage(s, x[mb].to(devices[s]) if s == 0 else buf[s])
            if s == S - 1:
                outs[mb] = h  # the last stage emits microbatch t - (S - 1)
            else:
                nxt[s + 1] = h.to(devices[s + 1])  # hand the activation to the next stage
                cost.collective("collective-permute", h.numel() * h.element_size(),
                                h.numel() * h.element_size())
        buf = nxt
    return torch.stack(outs)
