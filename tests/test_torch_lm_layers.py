"""The LM scaffold's blocks, port against the JAX package, one function at a
time: norms, RoPE, attention (prefill's online softmax over KV blocks and
decode's grouped-KV softmax with a cache write), the MLP, MoE dispatch with
dropped pairs, the causal conv, Mamba2, mLSTM and sLSTM in their chunked and
single-step forms.

Reduced configs (width 64), seeded numpy inputs, the reference's weights
(``init_params`` with ``PRNGKey(0)``) handed to both. The reference runs
under ``jax.jit`` on the CPU, as its own tests run it.

Tolerance (float32): within 1e-4 × max(1, max|reference|), as in
``test_torch_lm_archs.py``: the packages differ by float32 rounding only
(other contraction orders). Integer outputs and the drift points the port
mirrors on purpose (``jax.nn.softplus``, the tanh GELU, the masking
constant, ``lax.top_k``'s ties, the capacity drop) are held exactly or at
that tolerance on inputs that would show a difference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_config as jget_config
from repro.models import layers as jll
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.common import init_params as jinit
from repro_torch.models import layers as ll
from repro_torch.models import moe
from repro_torch.models import ssm

REL = 1e-4


def close(got, want, rel=REL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16 else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= rel * scale, f"{what}: max abs error {err} > {rel} x {scale}"


def close_tree(got, want, rel=REL, what=""):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        close(got[k], want[k], rel, f"{what}/{k}")


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def params(specs, seed=0):
    """The reference's weights for a spec tree, as (jax tree, torch tree)."""
    p = jinit(specs, jax.random.PRNGKey(seed))
    return p, to_torch(jax.tree.map(np.asarray, p))


def randn(rng, *shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def tiny(arch):
    """The reduced config of ``arch`` in both packages' config classes
    (identical fields)."""
    from repro_torch.configs.base import get_config

    return jget_config(arch).reduced(), get_config(arch).reduced()


# ------------------------------------------------------------- norms, rope
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    xj, xt = randn(rng, 2, 5, 64, scale=3.0)
    wj, wt = randn(rng, 64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jll.rmsnorm)(xj.astype(jd), wj, 1e-5)
    got = ll.rmsnorm(xt.to(td), wt, 1e-5)
    assert got.dtype == td
    # bfloat16: the mean square in float32, the multiplies in bfloat16, bit
    # for bit (multiplying in float32 and rounding once differs from the
    # reference in 275 of these 640 values)
    close(got, want, REL if dtype == "float32" else 0.0, "rmsnorm")


def test_rope():
    rng = np.random.default_rng(2)
    xj, xt = randn(rng, 2, 6, 4, 16)
    pos = rng.integers(0, 4096, size=(2, 6)).astype(np.int32)
    want = jax.jit(jll.rope, static_argnums=2)(xj, jnp.asarray(pos), 10_000.0)
    close(ll.rope(xt, torch.from_numpy(pos), 10_000.0), want, what="rope")


def test_softplus_and_gelu_follow_jax():
    """``jax.nn.softplus`` is logaddexp(x, 0) and ``jax.nn.gelu`` the tanh
    form, on inputs where the alternatives would differ (GELU's exact form
    by up to 5e-4 near |x| = 2)."""
    x = np.linspace(-60, 60, 4801).astype(np.float32)
    close(ssm.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), 1e-6, "softplus")
    g = np.linspace(-6, 6, 1201).astype(np.float32)
    close(F.gelu(torch.from_numpy(g), approximate="tanh"), jax.nn.gelu(jnp.asarray(g)), 1e-6, "gelu")
    assert float((F.gelu(torch.from_numpy(g)) - F.gelu(torch.from_numpy(g), approximate="tanh")).abs().max()) > 1e-4


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_with_unfilled_slots(causal):
    """Sq = 10 queries against 48 cache slots (3 KV blocks of 16), of which
    the last 20 are unfilled (BIG_POS) and the rest hold positions 0..27."""
    rng = np.random.default_rng(3)
    B, Sq, Skv, H, KV, hd = 2, 10, 48, 4, 2, 16
    qj, qt = randn(rng, B, Sq, H, hd)
    kj, kt = randn(rng, B, Skv, KV, hd)
    vj, vt = randn(rng, B, Skv, KV, hd)
    kv_pos = np.full((B, Skv), jll.BIG_POS, np.int32)
    kv_pos[:, :28] = np.arange(28)
    q_pos = np.broadcast_to(np.arange(18, 28, dtype=np.int32), (B, Sq)).copy()
    assert ll._pick_kv_block(Skv) == jll._pick_kv_block(Skv) == 16
    want = jax.jit(jll._attn_core, static_argnums=5)(qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal)
    got = ll._attn_core(qt, kt, vt, torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal)
    close(got, want, what="flash prefill")
    # the log-sum-exp the training backward will read
    kr, vr = (jnp.repeat(t, H // KV, axis=2) for t in (kj, vj))
    _, lse_j = jll._flash_fwd_impl(qj, kr, vr, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal, 16)
    _, lse_t = ll._flash_fwd(qt, kt.repeat_interleave(2, 2), vt.repeat_interleave(2, 2),
                             torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal, 16)
    close(lse_t, lse_j, what="lse")


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen1_5_0_5b"])  # GQA; QKV bias
def test_decode_attention_writes_cache(arch):
    cj, ct = tiny(arch)
    pj, pt = params(jll.attention_specs(cj))
    if cj.qkv_bias:  # nonzero biases, so that they count
        rng0 = np.random.default_rng(9)
        for n in ("bq", "bk", "bv"):
            b = rng0.normal(size=pj[n].shape).astype(np.float32)
            pj[n], pt[n] = jnp.asarray(b), torch.from_numpy(b)
    rng = np.random.default_rng(4)
    B, S = 2, 32
    xj, xt = randn(rng, B, 1, cj.d_model)
    kj, kt = randn(rng, B, S, cj.n_kv_heads, cj.resolved_head_dim)
    pos = np.where(np.arange(S) < 13, np.arange(S), jll.BIG_POS).astype(np.int32)
    cache = {"k": kj, "v": kj * 0.5, "pos": jnp.asarray(np.broadcast_to(pos, (B, S)).copy())}
    q_pos = np.full((B, 1), 13, np.int32)
    want, wc = jax.jit(lambda p, x, q, c: jll.attention(p, x, cj, q, cache=c))(pj, xj, jnp.asarray(q_pos), cache)
    tc = {"k": kt.clone(), "v": kt * 0.5, "pos": torch.from_numpy(np.broadcast_to(pos, (B, S)).copy())}
    got, gc = ll.attention(pt, xt, ct, torch.from_numpy(q_pos), cache=tc)
    close(got, want, what="decode attention")
    close_tree(gc, wc, what="cache")
    assert int(gc["pos"][0, 13]) == 13 and int(gc["pos"][0, 14]) == jll.BIG_POS


def test_cache_write_clamps_like_dynamic_update_slice():
    """Four positions written from slot 14 of a 16-slot cache: the reference's
    ``dynamic_update_slice`` clamps the start to 12, and so does the port."""
    cj, ct = tiny("tinyllama_1_1b")
    pj, pt = params(jll.attention_specs(cj))
    rng = np.random.default_rng(11)
    B, S = 2, 16
    xj, xt = randn(rng, B, 4, cj.d_model)
    q_pos = np.broadcast_to(np.arange(14, 18, dtype=np.int32), (B, 4)).copy()
    cache = jinit(jll.cache_specs(cj, B, S, layers=0), jax.random.PRNGKey(1))
    want, wc = jax.jit(lambda p, x, q, c: jll.attention(p, x, cj, q, cache=c))(pj, xj, jnp.asarray(q_pos), cache)
    tc = to_torch(jax.tree.map(np.asarray, cache))
    got, gc = ll.attention(pt, xt, ct, torch.from_numpy(q_pos), cache=tc)
    close(got, want, what="attention")
    close_tree(gc, wc, what="cache")
    assert gc["pos"][0].tolist() == [jll.BIG_POS] * 12 + [14, 15, 16, 17]


def test_cross_attention_over_memory():
    """``attention(..., kv_x=memory)``: keys and values from the memory, no
    RoPE, every memory slot visible (non-causal)."""
    cj, ct = tiny("seamless_m4t_v2")
    pj, pt = params(jll.attention_specs(cj))
    rng = np.random.default_rng(10)
    xj, xt = randn(rng, 2, 5, cj.d_model)
    mj, mt = randn(rng, 2, 7, cj.d_model)
    q_pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    m_pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    want, _ = jax.jit(lambda p, x, m, q, k: jll.attention(p, x, cj, q, kv_x=m, kv_pos=k, causal=False))(
        pj, xj, mj, jnp.asarray(q_pos), jnp.asarray(m_pos))
    got, _ = ll.attention(pt, xt, ct, torch.from_numpy(q_pos), kv_x=mt, kv_pos=torch.from_numpy(m_pos),
                          causal=False)
    close(got, want, what="cross attention")


def test_mlp():
    cj, ct = tiny("tinyllama_1_1b")
    pj, pt = params(jll.mlp_specs(cj))
    xj, xt = randn(np.random.default_rng(5), 2, 7, cj.d_model)
    close(ll.mlp(pt, xt), jax.jit(jll.mlp)(pj, xj), what="mlp")


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("B,S,router", [(2, 8, "random"), (1, 2, "random"), (3, 5, "zero")])
def test_moe_dense(B, S, router):
    """(2, 8): cap 10, nothing dropped; (1, 2): cap = max(int(1.25·2·2/4), 1)
    = 1 and pairs dropped; a zero router: every probability ties, and
    ``lax.top_k`` takes the lowest expert ids."""
    cj, ct = tiny("granite_moe")
    pj, pt = params(jmoe.moe_specs(cj))
    if router == "zero":
        pj["router"] = jnp.zeros_like(pj["router"])
        pt["router"] = torch.zeros_like(pt["router"])
    xj, xt = randn(np.random.default_rng(6), B, S, cj.d_model)
    want, aux_j = jax.jit(lambda p, x: jmoe._moe_dense(p, x, cj))(pj, xj)
    got, aux_t = moe._moe_dense(pt, xt, ct)
    close(got, want, what="moe out")
    close(aux_t, aux_j, what="moe aux")
    T, E, k = B * S, cj.n_experts, cj.experts_per_token
    cap = max(int(cj.capacity_factor * T * k / E), 1)
    probs = torch.softmax(ll.mm(xt.reshape(T, -1), pt["router"]), -1)
    _, eidx = moe.top_k(probs, k)
    per_expert = torch.bincount(eidx.reshape(-1), minlength=E)
    if (B, S) == (1, 2):
        assert cap == 1 and int((per_expert - cap).clamp_min(0).sum()) > 0  # pairs dropped
    if router == "zero":
        assert eidx.tolist() == [[0, 1]] * T


# ---------------------------------------------------------------- SSM blocks
def test_causal_conv_with_state():
    rng = np.random.default_rng(7)
    xj, xt = randn(rng, 2, 9, 12)
    wj, wt = randn(rng, 4, 12)
    bj, bt = randn(rng, 12)
    sj, st = randn(rng, 2, 3, 12)
    (yj, nj), (yt, nt) = jax.jit(jssm._causal_conv)(xj, wj, bj, sj), ssm._causal_conv(xt, wt, bt, st)
    close(yt, yj, what="conv y")
    close(nt, nj, what="conv state")
    (yj, nj), (yt, nt) = jax.jit(jssm._causal_conv)(xj, wj, bj), ssm._causal_conv(xt, wt, bt)
    close(yt, yj, what="conv y, no state")


def _state(specs, rng):
    """A recurrent state with random values (the sentinels kept where the
    spec has them: mLSTM's m at -1e30 in one row)."""
    j = jinit(specs, jax.random.PRNGKey(2))
    out = {}
    for k, v in j.items():
        a = (rng.normal(size=v.shape) * 0.5).astype(np.float32)
        if k == "m" and a.ndim == 2:
            a[0] = -1e30
        if k == "n" and a.ndim == 3 and "c" in j:  # sLSTM normalizer stays positive
            a = np.abs(a) + 1.0
        out[k] = a
    return {k: jnp.asarray(v) for k, v in out.items()}, {k: torch.from_numpy(v) for k, v in out.items()}


@functools.cache
def _block(kind):
    arch = {"mamba2": "zamba2_2_7b", "mlstm": "xlstm_125m", "slstm": "xlstm_125m"}[kind]
    cj, ct = tiny(arch)
    specs = {"mamba2": jssm.mamba2_specs, "mlstm": jssm.mlstm_specs, "slstm": jssm.slstm_specs}[kind](cj)
    states = {"mamba2": jssm.mamba2_state_specs, "mlstm": jssm.mlstm_state_specs,
              "slstm": jssm.slstm_state_specs}[kind](cj, 2)
    return cj, ct, params(specs), states


@pytest.mark.parametrize("kind,S", [("mamba2", 128), ("mamba2", 1), ("mlstm", 256), ("mlstm", 1)])
def test_ssm_block_chunked_and_single_step(kind, S):
    """Mamba2 at S = 128 (2 chunks of 64), mLSTM at S = 256 (2 chunks of
    128), each from a random state; S = 1 is the single-step decode."""
    cj, ct, (pj, pt), state_specs = _block(kind)
    rng = np.random.default_rng(8)
    xj, xt = randn(rng, 2, S, cj.d_model)
    sj, st = _state(state_specs, rng)
    single = S == 1
    jfn, tfn = getattr(jssm, kind), getattr(ssm, kind)
    yj, nsj = jax.jit(lambda p, x, s: jfn(p, x, cj, state=s, single_step=single))(pj, xj, sj)
    yt, nst = tfn(pt, xt, ct, state=st, single_step=single)
    close(yt, yj, what=f"{kind} y")
    close_tree(nst, nsj, what=f"{kind} state")


@pytest.mark.parametrize("S,Q", [(128, 64), (96, 32), (24, 24)])
def test_slstm_chunked_and_flat(S, Q):
    """The reference's sLSTM chunking: 64 steps where S divides, else 32,
    else one flat scan."""
    cj, ct, (pj, pt), state_specs = _block("slstm")
    assert ssm.slstm_chunk_len(S) == Q
    rng = np.random.default_rng(9)
    xj, xt = randn(rng, 2, S, cj.d_model)
    sj, st = _state(state_specs, rng)
    yj, nsj = jax.jit(lambda p, x, s: jssm.slstm(p, x, cj, state=s))(pj, xj, sj)
    yt, nst = ssm.slstm(pt, xt, ct, state=st)
    close(yt, yj, what="slstm y")
    close_tree(nst, nsj, what="slstm state")
    yj, _ = jax.jit(lambda p, x: jssm.slstm(p, x, cj))(pj, xj)  # fresh state: n = 1
    close(ssm.slstm(pt, xt, ct)[0], yj, what="slstm y, fresh state")
