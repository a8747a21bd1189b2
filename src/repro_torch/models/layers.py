"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

The JAX package's ``models/layers.py`` in plain PyTorch, with its arithmetic:
parameters are read through ``p[name]`` (a ``SpecModule`` or a dict), cast
to the compute dtype at each use, and every softmax runs in float32.
Prefill attention is the reference's online softmax over KV blocks of
``_pick_kv_block`` (the score matrix never materializes), decode one exact
softmax over the grouped-KV cache. The prefill attention's backward is the
reference's custom VJP (``_Flash``): it recomputes each block's tiles from
the saved log-sum-exp. There is no attention kernel: the reference has none
to port (its attention is ``jnp`` inside ``lax.scan``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.common import ParamSpec

BIG_POS = 1 << 30  # kv_position sentinel for unfilled cache slots
NEG = -1e30  # the reference's masking constant


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: operands of mixed dtypes promote to a common one."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the reference's dtype promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    stored (the reference's ``jax.checkpoint``)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------- norms/rope
def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # the mean square reduces in float32, the multiplies stay in x's dtype
    ms = x.float().square().mean(-1, keepdim=True)
    scale = torch.rsqrt(ms + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[:, :, None].float() * freqs[None, None, :]  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def attention_specs(cfg, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((H, hd), ("heads", None), init="zeros")
        p["bk"] = ParamSpec((KV, hd), ("kv_heads", None), init="zeros")
        p["bv"] = ParamSpec((KV, hd), ("kv_heads", None), init="zeros")
    return p


def _pick_kv_block(skv: int) -> int:
    for b in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if skv % b == 0:
            return b
    return 1


def _mask(kv_pos, q_pos, causal: bool) -> torch.Tensor:
    """(B, Sq, Skv): key slot visible to query."""
    if causal:
        return kv_pos[:, None, :] <= q_pos[:, :, None]
    return kv_pos[:, None, :] < BIG_POS


def _flash_fwd(q, k, v, q_pos, kv_pos, causal: bool, kv_block: int):
    """Online softmax over KV blocks, as the reference's ``_flash_fwd_impl``:
    per-block (Sq, kv_block) score tiles only. -> (out, lse)."""
    B, Sq, H, hd = q.shape
    scale = hd ** -0.5
    qf = q.float()
    m = torch.full((B, Sq, H), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for s0 in range(0, k.shape[1], kv_block):
        kb = k[:, s0:s0 + kv_block].float()
        vb = v[:, s0:s0 + kv_block].float()
        s = torch.einsum("bqhd,bshd->bqhs", qf, kb) * scale
        mask = _mask(kv_pos[:, s0:s0 + kv_block], q_pos, causal)
        s = torch.where(mask[:, :, None, :], s, NEG)
        m2 = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m2)
        p = torch.exp(s - m2[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhs,bshd->bqhd", p, vb)
        m = m2
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return out, m + torch.log(l)


def _flash_bwd(q, k, v, q_pos, kv_pos, out, lse, do, causal: bool, kv_block: int):
    """The reference's ``_flash_bwd``: per KV block, recompute the tile's
    exact softmax from the saved ``lse``; accumulate dq, emit the block's
    dk and dv. -> (dq, dk, dv) in the inputs' dtypes."""
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    dof = do.float()
    delta = (dof * out.float()).sum(-1)  # (B,Sq,H)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for s0 in range(0, k.shape[1], kv_block):
        kb = k[:, s0:s0 + kv_block].float()
        vb = v[:, s0:s0 + kv_block].float()
        s = torch.einsum("bqhd,bshd->bqhs", qf, kb) * scale
        mask = _mask(kv_pos[:, s0:s0 + kv_block], q_pos, causal)
        s = torch.where(mask[:, :, None, :], s, NEG)
        p = torch.exp(s - lse[..., None])  # exact softmax via the saved lse
        dp = torch.einsum("bqhd,bshd->bqhs", dof, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bqhs,bshd->bqhd", ds, kb)
        dks.append(torch.einsum("bqhs,bqhd->bshd", ds, qf))
        dvs.append(torch.einsum("bqhs,bqhd->bshd", p, dof))
    return dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward keeps only its
    inputs, output and log-sum-exp, never the per-block tiles."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal: bool, kv_block: int):
        out, lse = _flash_fwd(q, k, v, q_pos, kv_pos, causal, kv_block)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.causal, ctx.kv_block = causal, kv_block
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, do, ctx.causal, ctx.kv_block)
        return dq, dk, dv, None, None, None, None


def _attn_core(q, k, v, q_pos, kv_pos, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd), q_pos (B, Sq), kv_pos (B, Skv)
    with unfilled slots at BIG_POS."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    if Sq == 1:
        # decode: one exact softmax over the cache, grouped-KV form
        scale = hd ** -0.5
        qg = q.reshape(B, 1, KV, g, hd).float()
        s = torch.einsum("bqkgh,bskh->bqkgs", qg, k.float()) * scale
        s = torch.where(_mask(kv_pos, q_pos, causal)[:, :, None, None, :], s, NEG)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqkgs,bskh->bqkgh", p, v.float())
        return out.reshape(B, 1, H, hd).to(q.dtype)
    # GQA's repeat stays outside the Function: autograd sums each group's
    # dk/dv, as jnp.repeat's VJP does
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return _Flash.apply(q, k, v, q_pos, kv_pos, causal, _pick_kv_block(k.shape[1]))


def attention(p, x, cfg, q_pos, *, kv_x=None, kv_pos=None, cache: dict | None = None,
              use_rope: bool = True, causal: bool = True):
    """Returns (out (B, Sq, d), cache or None). A ``cache`` ({"k", "v",
    "pos"}, one layer's) is written in place at the slots given by
    ``q_pos[0, 0]`` (the serving layout's uniform position) and returned."""
    dt = x.dtype
    src = x if kv_x is None else kv_x
    q = ein("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = ein("bsd,dhk->bshk", src, p["wk"].to(dt))
    v = ein("bsd,dhk->bshk", src, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    kpos = (q_pos if kv_pos is None else kv_pos) if kv_x is None else kv_pos
    if use_rope and kv_x is None:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, kpos, cfg.rope_theta)

    if cache is not None:
        # dynamic_update_slice: the start is clamped so the update fits
        S, Sq = cache["k"].shape[1], q_pos.shape[1]
        slots = q_pos[0, 0].long().clamp(0, S - Sq) + torch.arange(Sq, device=x.device)
        cache["k"].index_copy_(1, slots, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, v.to(cache["v"].dtype))
        cache["pos"].index_copy_(1, slots, q_pos.to(cache["pos"].dtype).expand(cache["pos"].shape[0], Sq))
        k, v, kpos = cache["k"], cache["v"], cache["pos"]

    out = _attn_core(q, k, v, q_pos, kpos, causal=causal)
    out = ein("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, cache


def cache_specs(cfg, batch: int, seq: int, layers: int | None = None) -> dict:
    """KV-cache ParamSpec tree: (L, B, S, KV, hd) k and v in float32, (L, B,
    S) int32 positions with unfilled slots at BIG_POS."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = cfg.n_layers if layers is None else layers
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    return {
        "k": ParamSpec(lead + (batch, seq, KV, hd), lax + ("batch", "seq_kv", "kv_heads", None), init="zeros"),
        "v": ParamSpec(lead + (batch, seq, KV, hd), lax + ("batch", "seq_kv", "kv_heads", None), init="zeros"),
        "pos": ParamSpec(lead + (batch, seq), lax + ("batch", "seq_kv"), dtype=torch.int32, init="ones",
                         scale=float(BIG_POS)),
    }


# ---------------------------------------------------------------- MLP
def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec((d, f), ("embed", "ff")),
        "wg": ParamSpec((d, f), ("embed", "ff")),
        "wo": ParamSpec((f, d), ("ff", "embed")),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(mm(x, p["wg"].to(x.dtype))) * mm(x, p["wi"].to(x.dtype))
    return mm(h, p["wo"].to(x.dtype))


# ---------------------------------------------------------------- embeddings
def embed_specs(cfg) -> dict:
    return {
        "tok": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "norm_f": rmsnorm_spec(cfg.d_model),
        "head": ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
    }


def embed(p, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["tok"][tokens.long()].to(dtype)


def unembed(p, x: torch.Tensor, cfg) -> torch.Tensor:
    x = rmsnorm(x, p["norm_f"], cfg.norm_eps)
    return mm(x, p["head"].to(x.dtype))  # (B, S, padded_vocab)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in float32; ``mask`` zeroes padding/image positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(), dim=-1)[..., 0]
    loss = (lse - gold) * mask
    return loss.sum() / mask.sum().clamp_min(1)
