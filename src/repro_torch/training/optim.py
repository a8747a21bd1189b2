"""AdamW with the reference's LR schedule and ZeRO-1 moments, over a
model's ``state_dict``.

The JAX package's ``training/optim.py``: float32 moments, a global-norm
clip, bias correction and decoupled weight decay, with the reference's
arithmetic op for op. The update runs leaf by leaf and in place (parameters
and moments are overwritten, the gradients consumed), so a step holds one
leaf's temporaries beyond p, g, m and v; it launches 17 elementwise kernels
a leaf plus two a leaf for the global norm.

ZeRO-1 (``zero_axes``, ``moment_specs``): a moment carries an extra
``batch`` (= pod × data) split on its first unsplit dimension that divides
the data extent. Where the reference pins m and v to those shardings with
``with_sharding_constraint`` and lets XLA lay them out, ``adamw_update``
here stores each moment as the blocks of its ``NamedSharding`` (a
``Sharded``: each distinct block once, on its first position's device) and
updates each block in place from the matching slice of the gradient and
the parameter, which stay whole on the mesh's first device. AdamW is
elementwise and the clip's global norm is taken over the whole gradients,
so the result is the one-device update bit for bit.

Under an active cost recorder (``repro_torch.launch.cost``) each block's
update is charged to the position holding it, and the gradient and
parameter slices it reads from the first position, and the update it sends
back there, as point-to-point moves (``collective-permute``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch import cost
from repro_torch.models.common import ParamSpec, tree_map
from repro_torch.sharding.rules import Sharded


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` × lr (float32)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def zero_axes(spec: ParamSpec, data_extent: int) -> tuple:
    """Moment logical axes: param axes + 'batch' (=data) on the first
    unsharded dim divisible by the data extent (ZeRO-1 partitioning)."""
    axes = list(spec.axes)
    for i, (ax, size) in enumerate(zip(axes, spec.shape)):
        if ax is None and data_extent > 1 and size % data_extent == 0:
            axes[i] = "batch"
            break
    return tuple(axes)


def moment_specs(param_specs, rules) -> dict:
    """ParamSpec tree for m/v with ZeRO-1 axes (``rules``: a ``MeshRules``
    or None)."""
    extent = 1
    if rules is not None:
        for a in ("pod", "data"):
            extent *= rules.mesh.shape.get(a, 1)

    def one(s: ParamSpec) -> ParamSpec:
        axes = zero_axes(s, extent) if rules is not None else s.axes
        return ParamSpec(s.shape, axes, torch.float32, init="zeros")

    return tree_map(one, param_specs)


def init_opt_state(params: dict) -> dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)}


def global_norm(leaves) -> torch.Tensor:
    """√Σ g² over every leaf, in float32 (leaf sums added in the given order)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, opt_state: dict, moment_shardings: dict | None = None):
    """One AdamW step over ``params`` (name -> tensor) with ``grads`` of the
    same names. Updates ``params`` and ``opt_state``'s moments in place and
    scales ``grads`` in place. ``moment_shardings`` (name -> ``NamedSharding``)
    stores each moment as its blocks (a whole moment is split on its first
    update, a moment split another way re-split). -> (params, opt_state,
    {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads.values())
    # a tensor numerator: a Python scalar's ``/`` is reciprocal-then-multiply in torch
    scale = torch.clamp(torch.full_like(gn, cfg.grad_clip) / (gn + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    sf = step.float()
    bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf
    for k, p in params.items():
        g = grads[k].float().mul_(scale)
        sh = moment_shardings.get(k) if moment_shardings else None
        if sh is None:
            parts = [((), (), opt_state["m"][k], opt_state["v"][k])]
        else:
            for name in ("m", "v"):
                mom = opt_state[name][k]
                if not isinstance(mom, Sharded) or mom.sharding != sh:
                    whole = mom.full(p.device) if isinstance(mom, Sharded) else mom
                    opt_state[name][k] = sh.split(whole)
            m, v = opt_state["m"][k], opt_state["v"][k]
            parts = [(c, s, m.blocks[c], v.blocks[c]) for c, s in sh.slices(tuple(p.shape)).items()]
        for c, s, m, v in parts:
            dev = m.device
            with cost.at(c):
                gs = g[s].to(dev)
                m.mul_(b1).add_((1 - b1) * gs)
                v.mul_(b2).add_((1 - b2) * gs * gs)
                ps = p[s].float().to(dev)
                delta = (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev)) + cfg.eps) + cfg.weight_decay * ps
                upd = lr.to(dev) * delta
                if any(c):  # g and p slices in, the update out: the block lies elsewhere
                    cost.collective("collective-permute", 3 * gs.numel() * 4, 3 * gs.numel() * 4)
            upd = upd.to(p.device)
            if p.dtype == torch.float32:
                p[s].sub_(upd)
            else:
                p[s].copy_(p[s].float() - upd)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, {"lr": lr, "grad_norm": gn}
