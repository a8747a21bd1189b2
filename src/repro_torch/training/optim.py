"""AdamW with the reference's LR schedule, over a model's ``state_dict``.

The JAX package's ``training/optim.py`` on one device: float32 moments, a
global-norm clip, bias correction and decoupled weight decay, with the
reference's arithmetic op for op. The update runs leaf by leaf and in
place (parameters and moments are overwritten, the gradients consumed), so a
step holds one leaf's temporaries beyond p, g, m and v; it launches 17
elementwise kernels a leaf plus two a leaf for the global norm. The
reference's ZeRO-1 moment shardings (``zero_axes``, ``moment_specs``) belong
to a mesh and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math

import torch


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


def init_opt_state(params: dict) -> dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)}


def global_norm(leaves) -> torch.Tensor:
    """√Σ g² over every leaf, in float32 (leaf sums added in the given order)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, opt_state: dict):
    """One AdamW step over ``params`` (name -> tensor) with ``grads`` of the
    same names. Updates ``params`` and ``opt_state``'s moments in place and
    scales ``grads`` in place. -> (params, opt_state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads.values())
    # a tensor numerator: a Python scalar's ``/`` is reciprocal-then-multiply in torch
    scale = torch.clamp(torch.full_like(gn, cfg.grad_clip) / (gn + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    sf = step.float()
    bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf
    for k, p in params.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        g = grads[k].float().mul_(scale)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_(p.float() - lr * delta)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, {"lr": lr, "grad_norm": gn}
