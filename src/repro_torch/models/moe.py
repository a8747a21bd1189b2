"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort dispatch.

The JAX package's dense dispatch (``models/moe.py`` ``_moe_dense``) in plain
PyTorch: tokens are grouped by a stable sort on expert id, each expert's
first ``cap`` tokens fill its capacity buffer (the rest go to a trash row and
are dropped), the experts run as one batched matmul, and the gated outputs
are added back to their tokens. The reference's ``_moe_sharded`` runs only
under an ambient TPU mesh; the port always takes the dense path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import mm


def moe_specs(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None)),
        "wi": ParamSpec((E, d, f), ("experts", "embed", "ff")),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "ff")),
        "wo": ParamSpec((E, f, d), ("experts", "ff", "embed")),
    }


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties broken toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    return _moe_dense(p, x, cfg)


def _moe_dense(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dev = x.device
    xt = x.reshape(T, d)

    logits = mm(xt, p["router"].to(xt.dtype)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, k)  # (T, k)
    # torch.maximum: a tie splits its gradient, as jnp.maximum
    gate = gate / torch.maximum(gate.sum(-1, keepdim=True), torch.full((), 1e-9, device=dev))

    # Switch aux loss: fraction of tokens per expert × mean router prob
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones(T * k, dtype=torch.float32, device=dev)) / (T * k)
    aux = (me * ce).sum() * E

    cap = max(int(cfg.capacity_factor * T * k / E), 1)

    flat_e = eidx.reshape(-1)  # (T*k,)
    flat_gate = gate.reshape(-1)
    src = torch.arange(T, device=dev).repeat_interleave(k)

    order = torch.sort(flat_e, stable=True).indices  # group by expert
    e_sorted = flat_e[order]
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[e_sorted]  # slot within expert
    keep = pos < cap
    slot = torch.where(keep, e_sorted * cap + pos, E * cap)  # overflow -> trash row

    xin = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=dev)
    xin[slot] = xt[src[order]]
    xin = xin[: E * cap].reshape(E, cap, d)

    wi, wg, wo = (p[n].to(x.dtype) for n in ("wi", "wg", "wo"))
    hout = torch.bmm(F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wi), wo)  # (E, cap, d)
    hflat = torch.cat([hout.reshape(E * cap, d), torch.zeros((1, d), dtype=x.dtype, device=dev)])

    contrib = hflat[slot] * flat_gate[order][:, None].to(x.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=x.dtype, device=dev))
    # the reference's scatter-add, in its order: each token's contributions
    # added one at a time in the sorted (expert-ascending) order, in x's
    # dtype; a sum over k in a fixed order, so no atomics and no run-to-run
    # difference
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib  # back to (token, top-k slot) order
    by_expert = torch.argsort(eidx, dim=-1)  # a token's k experts are distinct
    per_tok = per_tok.reshape(T, k, d).gather(1, by_expert[..., None].expand(T, k, d))
    out = torch.zeros((T, d), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + per_tok[:, j]
    return out.reshape(B, S, d), aux
