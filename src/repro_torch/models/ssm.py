"""State-space / recurrent blocks: Mamba2 (SSD), xLSTM (mLSTM + sLSTM).

The JAX package's ``models/ssm.py`` in plain PyTorch, chunk for chunk:
prefill runs the chunked forms (quadratic within a chunk, a loop over chunks
carrying the recurrent state) with the reference's chunk sizes and asserts;
decode is the O(1)/token recurrent update. Each ``lax.scan`` is a Python
loop over the same steps; the sLSTM's steps run through ``launch.cost.scan``,
which the dry-run's abstract trace folds to one step charged S times.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import cost
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import NEG, ein, mm, remat, rmsnorm, rmsnorm_spec

CHUNK = 128  # mLSTM chunk
MAMBA_CHUNK = 64  # Mamba2 (SSD) chunk


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere (torch's ``softplus``
    turns linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# =============================================================== Mamba2 (SSD)
def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    N = cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = din + 2 * N
    return {
        "in_proj": ParamSpec((d, 2 * din + 2 * N + nh), ("embed", "d_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), (None, "d_inner")),
        "conv_b": ParamSpec((conv_ch,), ("d_inner",), init="zeros"),
        "A_log": ParamSpec((nh,), (None,), init="zeros"),
        "D": ParamSpec((nh,), (None,), init="ones"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros"),
        "norm": ParamSpec((din,), ("d_inner",), init="ones"),
        "out_proj": ParamSpec((din, d), ("d_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv. x (B, S, C), w (K, C). Returns (y, new_state).
    A float32 state promotes the output to float32, as in the reference."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    new_state = xp[:, -(K - 1):, :] if K > 1 else state
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(K))
    return F.silu(y + b[None, None, :]), new_state


def mamba2(p, x: torch.Tensor, cfg, state: dict | None = None, single_step: bool = False):
    """x (B, S, d) -> (y (B, S, d), new_state {ssm (B,nh,hd,N), conv})."""
    B, S, d = x.shape
    zxbcdt = mm(x, p["in_proj"].to(x.dtype))
    din = cfg.ssm_expand * d
    N = cfg.ssm_state
    nh = cfg.ssm_heads
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:2 * din + 2 * N]
    dt_raw = zxbcdt[..., 2 * din + 2 * N:]
    hd = cfg.ssm_head_dim

    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype), conv_state)
    xin = xBC[..., :din].reshape(B, S, nh, hd)
    Bc = xBC[..., din:din + N].float()
    Cc = xBC[..., din + N:].float()

    dt = softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,nh)
    a = -torch.exp(p["A_log"].float())  # (nh,)
    dA = dt * a[None, None, :]  # (B,S,nh) log-decay per step

    if state is not None:
        h0 = state["ssm"]
    else:
        h0 = torch.zeros((B, nh, hd, N), dtype=torch.float32, device=x.device)

    if single_step:
        # recurrent update: h = h*exp(dA) + dt * x ⊗ B ; y = h·C
        xf = xin[:, 0].float()  # (B,nh,hd)
        h1 = h0 * torch.exp(dA[:, 0])[:, :, None, None] + (
            dt[:, 0][:, :, None, None] * xf[:, :, :, None] * Bc[:, 0][:, None, None, :]
        )
        y = torch.einsum("bhdn,bn->bhd", h1, Cc[:, 0])[:, None]  # (B,1,nh,hd)
        hlast = h1
    else:
        Q = min(MAMBA_CHUNK, S)
        assert S % Q == 0, (S, Q)
        nc = S // Q
        xc = xin.reshape(B, nc, Q, nh, hd).float()
        Bcc = Bc.reshape(B, nc, Q, N)
        Ccc = Cc.reshape(B, nc, Q, N)
        dtc = dt.reshape(B, nc, Q, nh)
        cum = torch.cumsum(dA.reshape(B, nc, Q, nh), dim=2)  # (B,nc,Q,nh)

        # within-chunk: y_diag[t] = Σ_{j<=t} e^{cum_t-cum_j} dt_j (C_t·B_j) x_j
        decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,nh)
        mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        w = torch.exp(torch.where(mask[None, None, :, :, None], decay, NEG))
        scores = torch.einsum("bcin,bcjn->bcij", Ccc, Bcc)  # (B,nc,Q,Q)
        wdt = w * dtc[:, :, None, :, :]  # (B,nc,Q,Q,nh)
        y_diag = torch.einsum("bcij,bcijh,bcjhd->bcihd", scores, wdt, xc)

        # chunk states: S_c = Σ_j e^{cum_Q-cum_j} dt_j B_j ⊗ x_j  (B,nc,nh,hd,N)
        sdecay = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B,nc,Q,nh)
        S_c = torch.einsum("bcjh,bcjn,bcjhd->bchdn", sdecay, Bcc, xc)

        # inter-chunk scan: H_c = H_{c-1} * e^{sum_c} + S_c, emitting the
        # state entering each chunk
        seg = cum[:, :, -1, :]  # (B,nc,nh)
        h, h_in = h0, []
        for c in range(nc):
            h_in.append(h)
            h = h * torch.exp(seg[:, c])[:, :, None, None] + S_c[:, c]
        hlast = h
        h_in = torch.stack(h_in, dim=1)  # (B,nc,nh,hd,N)

        # cross-chunk: y_off[t] = e^{cum_t} C_t · H_in
        y_off = torch.einsum("bcin,bchdn,bcih->bcihd", Ccc, h_in, torch.exp(cum))
        y = (y_diag + y_off).reshape(B, S, nh, hd)

    y = y + xin.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, din).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = mm(y, p["out_proj"].to(x.dtype))
    return out, {"ssm": hlast, "conv": new_conv}


def mamba2_state_specs(cfg, batch: int, lead: tuple = (), lead_axes: tuple = ()) -> dict:
    din = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = din + 2 * N
    return {
        "ssm": ParamSpec(lead + (batch, nh, cfg.ssm_head_dim, N), lead_axes + ("batch", None, None, None),
                         dtype=torch.float32, init="zeros"),
        "conv": ParamSpec(lead + (batch, cfg.ssm_conv - 1, conv_ch), lead_axes + ("batch", None, "d_inner"),
                          init="zeros"),
    }


# =============================================================== xLSTM blocks
def mlstm_specs(cfg) -> dict:
    d = cfg.d_model
    din = 2 * d  # projection factor 2 (paper)
    nh = cfg.n_heads
    hd = din // nh
    return {
        "norm_in": rmsnorm_spec(d),
        "up": ParamSpec((d, 2 * din), ("embed", "d_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, din), (None, "d_inner")),
        "conv_b": ParamSpec((din,), ("d_inner",), init="zeros"),
        "wq": ParamSpec((din, nh, hd), ("d_inner", "heads", None)),
        "wk": ParamSpec((din, nh, hd), ("d_inner", "heads", None)),
        "wv": ParamSpec((din, nh, hd), ("d_inner", "heads", None)),
        "w_if": ParamSpec((din, 2 * nh), ("d_inner", None)),  # input/forget gates
        "b_if": ParamSpec((2 * nh,), (None,), init="zeros"),
        "norm_h": ParamSpec((din,), ("d_inner",), init="ones"),
        "down": ParamSpec((din, d), ("d_inner", "embed")),
    }


def _mlstm_chunk(carry, qb, kb, vb, ib, Fb):
    """One chunk of the stabilized mLSTM; inputs (B,Q,nh,*). -> (carry, h)."""
    C0, n0, m0 = carry
    Q = qb.shape[1]
    # D_ij = F_i - F_j + i_j (j<=i), cross term m0 + F_i
    Dm = Fb[:, :, None, :] - Fb[:, None, :, :] + ib[:, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=qb.device).tril()
    Dm = torch.where(mask[None, :, :, None], Dm, NEG)
    m_intra = Dm.amax(dim=2)  # (B,Q,nh)
    m_i = torch.maximum(m_intra, m0[:, None, :] + Fb)
    w = torch.exp(Dm - m_i[:, :, None, :])  # (B,Q,Q,nh)
    s = torch.einsum("bihk,bjhk->bijh", qb, kb)  # (B,Q,Q,nh)
    cross = torch.exp(Fb + m0[:, None, :] - m_i)  # (B,Q,nh)
    num = torch.einsum("bijh,bijh,bjhv->bihv", s, w, vb) + cross[..., None] * torch.einsum(
        "bhkv,bihk->bihv", C0, qb)
    den = torch.einsum("bijh,bjhk,bihk->bih", w, kb, qb) + cross * torch.einsum("bhk,bihk->bih", n0, qb)
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    # state to the next chunk
    FQ = Fb[:, -1, :]  # (B,nh)
    m1 = torch.maximum(m0 + FQ, (FQ[:, None, :] - Fb + ib).amax(dim=1))
    sdec = torch.exp(FQ[:, None, :] - Fb + ib - m1[:, None, :])  # (B,Q,nh)
    C1 = C0 * torch.exp(m0 + FQ - m1)[:, :, None, None] + torch.einsum("bjh,bjhk,bjhv->bhkv", sdec, kb, vb)
    n1 = n0 * torch.exp(m0 + FQ - m1)[:, :, None] + torch.einsum("bjh,bjhk->bhk", sdec, kb)
    return (C1, n1, m1), h


def mlstm(p, x: torch.Tensor, cfg, state: dict | None = None, single_step: bool = False):
    """Stabilized matrix-LSTM, chunked parallel form. x (B,S,d)."""
    B, S, d = x.shape
    din = 2 * d
    nh = cfg.n_heads
    hd = din // nh
    dt = x.dtype
    xn = rmsnorm(x, p["norm_in"], cfg.norm_eps)
    up = mm(xn, p["up"].to(dt))
    u, gate = up[..., :din], up[..., din:]
    conv_state = state["conv"] if state is not None else None
    c, new_conv = _causal_conv(u, p["conv_w"].to(dt), p["conv_b"].to(dt), conv_state)

    q = ein("bsd,dhk->bshk", c, p["wq"].to(dt)).float()
    k = ein("bsd,dhk->bshk", c, p["wk"].to(dt)).float() * hd ** -0.5
    v = ein("bsd,dhk->bshk", u, p["wv"].to(dt)).float()
    ifg = mm(c, p["w_if"].to(dt)).float() + p["b_if"].float()
    logi = ifg[..., :nh]  # (B,S,nh) log input gate (pre-exp)
    logf = F.logsigmoid(ifg[..., nh:])  # (B,S,nh)

    if state is not None:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    else:
        C0 = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, nh, hd), dtype=torch.float32, device=x.device)
        m0 = torch.full((B, nh), NEG, dtype=torch.float32, device=x.device)

    if single_step:
        Fg = logf[:, 0]  # (B,nh)
        Ig = logi[:, 0]
        m1 = torch.maximum(Fg + m0, Ig)
        fs = torch.exp(Fg + m0 - m1)[:, :, None, None]
        is_ = torch.exp(Ig - m1)[:, :, None, None]
        C1 = C0 * fs + is_ * torch.einsum("bhk,bhv->bhkv", k[:, 0], v[:, 0])
        n1 = n0 * fs[..., 0] + is_[..., 0] * k[:, 0]
        num = torch.einsum("bhkv,bhk->bhv", C1, q[:, 0])
        den = torch.einsum("bhk,bhk->bh", n1, q[:, 0]).abs()
        h = num / torch.maximum(den, torch.exp(-m1))[:, :, None]
        h = h[:, None]  # (B,1,nh,hd)
        new_state = {"C": C1, "n": n1, "m": m1, "conv": new_conv}
    else:
        Q = min(CHUNK, S)
        assert S % Q == 0
        nc = S // Q
        Fcum = torch.cumsum(logf.reshape(B, nc, Q, nh), dim=2)  # (B,nc,Q,nh)
        qc, kc, vc = (t.reshape(B, nc, Q, nh, hd) for t in (q, k, v))
        ic = logi.reshape(B, nc, Q, nh)
        carry, hs = (C0, n0, m0), []
        for ci in range(nc):
            carry, h = _mlstm_chunk(carry, qc[:, ci], kc[:, ci], vc[:, ci], ic[:, ci], Fcum[:, ci])
            hs.append(h)
        h = torch.stack(hs, dim=1).reshape(B, S, nh, hd)
        C1, n1, m1 = carry
        new_state = {"C": C1, "n": n1, "m": m1, "conv": new_conv}

    hflat = h.reshape(B, -1, din).to(dt)
    hflat = rmsnorm(hflat, p["norm_h"], cfg.norm_eps) * F.silu(gate)
    return x + mm(hflat, p["down"].to(dt)), new_state


def mlstm_state_specs(cfg, batch: int, lead=(), lead_axes=()) -> dict:
    din = 2 * cfg.d_model
    nh = cfg.n_heads
    hd = din // nh
    f32 = torch.float32
    return {
        "C": ParamSpec(lead + (batch, nh, hd, hd), lead_axes + ("batch", None, None, None), dtype=f32, init="zeros"),
        "n": ParamSpec(lead + (batch, nh, hd), lead_axes + ("batch", None, None), dtype=f32, init="zeros"),
        "m": ParamSpec(lead + (batch, nh), lead_axes + ("batch", None), dtype=f32, init="ones", scale=NEG),
        "conv": ParamSpec(lead + (batch, cfg.ssm_conv - 1, din), lead_axes + ("batch", None, "d_inner"), init="zeros"),
    }


def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    return {
        "norm_in": rmsnorm_spec(d),
        "wx": ParamSpec((d, 4, nh, hd), ("embed", None, "heads", None)),
        "r": ParamSpec((4, nh, hd, hd), (None, "heads", None, None), scale=0.1),
        "b": ParamSpec((4, nh, hd), (None, "heads", None), init="zeros"),
        "norm_h": rmsnorm_spec(d),
        "up": ParamSpec((d, 2 * d), ("embed", "ff")),
        "down": ParamSpec((2 * d, d), ("ff", "embed")),
    }


def _slstm_step(carry, xt, wx, r, b, n_floor):
    """One sLSTM step: the gates from the input and the recurrent state,
    exponential gating with the stabilizer m."""
    c, n, m, h = carry
    gx = ein("bd,dghk->bghk", xt, wx).float()
    rec = torch.einsum("bhk,ghkl->bghl", h, r)
    zt, it, ft, ot = (gx[:, g] + rec[:, g] + b[g][None] for g in range(4))
    mt = torch.maximum(ft + m, it)
    ip = torch.exp(it - mt)
    fp = torch.exp(ft + m - mt)
    ct = fp * c + ip * torch.tanh(zt)
    nt = fp * n + ip
    ht = torch.sigmoid(ot) * ct / torch.maximum(nt, n_floor)
    return (ct, nt, mt, ht), ht


def slstm_chunk_len(S: int) -> int:
    """The reference's sLSTM chunk: 64 or 32 steps where S divides, else S
    (one flat scan)."""
    for cand in (64, 32):
        if S % cand == 0:
            return cand
    return S


def slstm(p, x: torch.Tensor, cfg, state: dict | None = None, single_step: bool = False,
          train: bool = False):
    """Scalar-memory LSTM with exponential gating, one step at a time. Under
    ``train`` each chunk of Q steps is recomputed in the backward (the
    reference's checkpointed chunk body) where there is more than one."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    dev = x.device
    xn = rmsnorm(x, p["norm_in"], cfg.norm_eps)

    if state is not None:
        carry = (state["c"], state["n"], state["m"], state["h"])
    else:
        zeros = torch.zeros((B, nh, hd), dtype=torch.float32, device=dev)
        carry = (zeros, torch.ones((B, nh, hd), dtype=torch.float32, device=dev), zeros, zeros)

    r = p["r"].float()
    b = p["b"].float()
    wx = p["wx"].to(x.dtype)
    n_floor = torch.full((), 1e-6, device=dev)  # torch.maximum: a tie splits its gradient, as jnp.maximum

    def chunk(carry, xc):  # xc (B, Q, d)
        carry, hs = cost.scan(_slstm_step, carry, xc.unbind(1), (wx, r, b, n_floor))
        return carry, torch.stack(hs, dim=1)

    # the reference scans S/Q chunks of Q steps (Q = 64 or 32), or all S
    # steps flat; either way the same steps in the same order
    Q = slstm_chunk_len(S)
    hs = []
    for c0 in range(0, S, Q):
        if train and S > Q:
            carry, hc = remat(chunk, carry, xn[:, c0:c0 + Q])
        else:
            carry, hc = chunk(carry, xn[:, c0:c0 + Q])
        hs.append(hc)
    c1, n1, m1, h1 = carry
    h = torch.cat(hs, dim=1).reshape(B, S, d).to(x.dtype)
    h = rmsnorm(h, p["norm_h"], cfg.norm_eps)
    x = x + h
    # small FFN (up factor 2, gelu in its tanh form, as jax.nn.gelu) after the sLSTM
    u = mm(x, p["up"].to(x.dtype))
    x = x + mm(F.gelu(u, approximate="tanh"), p["down"].to(x.dtype))
    return x, {"c": c1, "n": n1, "m": m1, "h": h1}


def slstm_state_specs(cfg, batch: int, lead=(), lead_axes=()) -> dict:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    f32 = torch.float32
    ax = lead_axes + ("batch", None, None)
    return {
        "c": ParamSpec(lead + (batch, nh, hd), ax, dtype=f32, init="zeros"),
        "n": ParamSpec(lead + (batch, nh, hd), ax, dtype=f32, init="ones"),
        "m": ParamSpec(lead + (batch, nh, hd), ax, dtype=f32, init="zeros"),
        "h": ParamSpec(lead + (batch, nh, hd), ax, dtype=f32, init="zeros"),
    }
