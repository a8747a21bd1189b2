"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort dispatch.

The JAX package's ``models/moe.py`` in plain PyTorch, both dispatch paths:

  - ``_moe_dense``: tokens are grouped by a stable sort on expert id, each
    expert's first ``cap`` tokens fill its capacity buffer (the rest go to a
    trash row and are dropped), the experts run as one batched matmul, and
    the gated outputs are added back to their tokens.
  - ``_moe_sharded``: the reference's ``shard_map`` path over a (data,
    model) mesh, single-controller: routing and capacity per data shard
    (``T_l = (B // D)·S`` tokens), the aux loss the mean of the shards'
    values, each model position gathering only its ``E/M`` experts'
    capacity slots (assignments of other experts go to a trash expert),
    and the positions' outputs summed over ``model``. Whenever D > 1 that
    is not the dense path's result (capacity and aux are per shard).

``moe_ffn`` takes the sharded path when given a ``mesh`` that supports it
(``_moe_axes``), where the reference takes it under an ambient mesh; the
train step never passes one, as the reference never sets one there.
"""
from __future__ import annotations

import math

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


def _moe_axes(cfg, batch: int, mesh):
    """(data_axes, model_axis, D, M) if ``mesh`` supports sharded dispatch:
    the reference's ``_ambient_moe_axes`` on an explicit mesh, with its
    fallbacks (no ``model`` axis, ``n_experts % M``, ``batch % D``)."""
    if mesh is None or "model" not in mesh.axis_names:
        return None
    M = mesh.shape["model"]
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    D = math.prod(mesh.shape[a] for a in data_axes)
    if cfg.n_experts % M or batch % D:
        return None
    return data_axes, "model", D, M


def moe_ffn(p, x: torch.Tensor, cfg, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar). Dispatches to the
    sharded path when ``mesh`` (a ``repro_torch.launch.mesh.Mesh``) has a
    model axis that the experts and its data axes that the batch divide."""
    ax = _moe_axes(cfg, x.shape[0], mesh)
    if ax is not None:
        return _moe_sharded(p, x, cfg, mesh, *ax)
    return _moe_dense(p, x, cfg)


def _route(xt: torch.Tensor, router: torch.Tensor, cfg):
    """-> (gate (T, k), eidx (T, k), aux) for tokens ``xt``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    T = xt.shape[0]
    dev = xt.device
    logits = mm(xt, router.to(xt.dtype)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, k)  # (T, k)
    # torch.maximum: a tie splits its gradient, as jnp.maximum
    gate = gate / torch.maximum(gate.sum(-1, keepdim=True), torch.full((), 1e-9, device=dev))
    # Switch aux loss: fraction of tokens per expert × mean router prob
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones(T * k, dtype=torch.float32, device=dev)) / (T * k)
    return gate, eidx, (me * ce).sum() * E


def _experts(xin: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """Each expert's gated MLP on its capacity buffer: (E, cap, d)."""
    wi, wg, wo = (w.to(xin.dtype) for w in (wi, wg, wo))
    return torch.bmm(F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wi), wo)


def _combine(contrib: torch.Tensor, order: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """The reference's scatter-add of the gated outputs back to their
    tokens, in its order: ``contrib`` holds one row per (token, top-k slot)
    assignment in the sorted (expert-ascending) ``order``, zero where the
    assignment was dropped; each token's rows are added one at a time in
    expert order, in ``contrib``'s dtype. A sum over k in a fixed order, so
    no atomics and no run-to-run difference."""
    T, k = eidx.shape
    d = contrib.shape[-1]
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib  # back to (token, top-k slot) order
    by_expert = torch.argsort(eidx, dim=-1)  # a token's k experts are distinct
    per_tok = per_tok.reshape(T, k, d).gather(1, by_expert[..., None].expand(T, k, d))
    out = torch.zeros((T, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + per_tok[:, j]
    return out


def _moe_sharded(p, x: torch.Tensor, cfg, mesh, data_axes, model_ax, D, M):
    """Data shard d routes on position (d, 0)'s device; position (d, j)
    dispatches to and runs experts [j·E/M, (j+1)·E/M) on its own device;
    the shard's output is the sum over j (in j order) on ``x``'s device, and
    the shards' outputs are concatenated over the batch."""
    E, k = cfg.n_experts, cfg.experts_per_token
    e_per = E // M
    B, S, d = x.shape
    B_l = B // D
    T_l = B_l * S
    cap = max(1, int(cfg.capacity_factor * T_l * k / E))
    ns = e_per * cap
    grid = mesh.grid(data_axes, model_ax)  # (D, M) devices
    outs, auxes = [], []
    for di in range(D):
        xt = x[di * B_l:(di + 1) * B_l].reshape(T_l, d).to(grid[di, 0])
        gate, eidx, aux = _route(xt, p["router"].to(xt.device), cfg)
        auxes.append(aux.to(x.device))
        out = None
        for j in range(M):
            dev = grid[di, j]
            xj, ej, gj = xt.to(dev), eidx.to(dev), gate.to(dev)
            my0 = j * e_per
            flat_e, flat_gate = ej.reshape(-1), gj.reshape(-1)
            src = torch.arange(T_l, device=dev).repeat_interleave(k)
            mine = (flat_e >= my0) & (flat_e < my0 + e_per)
            local_e = torch.where(mine, flat_e - my0, e_per)  # foreign -> trash expert
            order = torch.sort(local_e, stable=True).indices
            e_sorted = local_e[order]
            starts = torch.searchsorted(e_sorted, torch.arange(e_per + 1, device=dev))
            pos = torch.arange(T_l * k, device=dev) - starts[e_sorted.clamp(0, e_per)]
            keep = (e_sorted < e_per) & (pos < cap)
            slot = torch.where(keep, e_sorted * cap + pos, ns)
            tok_for_slot = torch.zeros(ns + 1, dtype=torch.int64, device=dev)
            tok_for_slot[slot] = src[order]  # only the trash slot takes duplicates
            xin = xj[tok_for_slot[:ns]].reshape(e_per, cap, d)  # slot-granular gather
            w = [p[n][my0:my0 + e_per].to(dev) for n in ("wi", "wg", "wo")]
            hout = _experts(xin, *w)  # (E/M, cap, d)
            hflat = torch.cat([hout.reshape(ns, d), torch.zeros((1, d), dtype=x.dtype, device=dev)])
            g_kept = torch.where(keep, flat_gate[order], torch.zeros((), device=dev))
            part = _combine(hflat[slot] * g_kept[:, None].to(x.dtype), order, ej).to(x.device)
            out = part if out is None else out + part  # merge expert shards (row-parallel)
        outs.append(out.reshape(B_l, S, d))
    aux = auxes[0]
    for a in auxes[1:]:
        aux = aux + a
    return torch.cat(outs), aux / D  # the reference's pmean over the data axes


def _moe_dense(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dev = x.device
    xt = x.reshape(T, d)
    gate, eidx, aux = _route(xt, p["router"], cfg)

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

    hout = _experts(xin, p["wi"], p["wg"], p["wo"])  # (E, cap, d)
    hflat = torch.cat([hout.reshape(E * cap, d), torch.zeros((1, d), dtype=x.dtype, device=dev)])

    contrib = hflat[slot] * flat_gate[order][:, None].to(x.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=x.dtype, device=dev))
    return _combine(contrib, order, eidx).reshape(B, S, d), aux
