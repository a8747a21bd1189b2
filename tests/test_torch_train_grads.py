"""The LM scaffold's backward, port against the JAX package.

The flash attention's custom backward (``_Flash``) against ``jax.vjp`` of
the reference's ``_flash`` on the same inputs and cotangent; every arch's
loss and gradients against ``jax.value_and_grad(model.loss)`` (reduced
configs, float32, the reference's weights carried across by
``models/convert.py``; one ``jax.jit`` compile an arch, shared within this
module); and the per-layer recompute, which must not change a bit.

Tolerance (float32): every gradient leaf within 1e-4 × max(1, max|reference
leaf|), as the LM tests hold outputs, except the encoder-decoder's at 1e-3:
its cross-attention's backward amplifies the forward's float32 rounding of
the encoder memory about thirtyfold, and the two packages round that forward
differently (torch's CPU matmuls about twice as far from a float64
evaluation as XLA's), so its encoder-side leaves differ by up to 4.5e-4 of
the scale; against a float64 evaluation the port's float32 gradients lie
5.1e-4 of the scale away and the reference's 5.7e-5
(``test_float32_gradients_near_float64``). Every other arch stays within
4.4e-5. The flash backward itself is within 1e-5 of the scale
in float32 (1e-6 seen) and 1e-2 in bfloat16 (a bfloat16 ulp is 2^-8 of the
value: dq/dk/dv are cast from float32 sums taken in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.models import layers as jll
from repro.models.common import init_params as jinit
from repro.models.registry import build_model as jbuild
from repro.models.registry import materialize_batch as jbatch
from repro_torch.configs.base import get_config
from repro_torch.models import layers as ll
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.models.registry import build_model, materialize_batch

S, B = 24, 2
REL = 1e-4
REL_ENCDEC = 1e-3


def close(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16 else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= rel * scale, f"{what}: max abs error {err} > {rel} x {scale}"


# ------------------------------------------------------------------ flash
def _flash_inputs(seed, Sq, Skv, H, KV=None, dtype=np.float32, unfilled=0):
    rng = np.random.default_rng(seed)
    KV = KV or H
    q = rng.normal(size=(B, Sq, H, 16)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, 16)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, 16)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, 16)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    if unfilled:  # cache slots not yet written: BIG_POS, never visible
        kv_pos[:, -unfilled:] = ll.BIG_POS
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)]
    return jx, tx, q_pos, kv_pos


def _port_vjp(fn, tx):
    q, k, v, do = (t.clone().requires_grad_(i < 3) for i, t in enumerate(tx))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("causal,Sq,Skv,block,unfilled,dtype", [
    (True, 24, 24, 8, 0, "float32"),  # three KV blocks
    (True, 64, 64, 16, 0, "float32"),  # four
    (False, 24, 6, 2, 0, "float32"),  # cross-attention shape: memory of 6
    (False, 16, 32, 8, 8, "float32"),  # unfilled slots masked
    (True, 16, 48, 16, 0, "float32"),  # queries at the end of a longer KV
    (True, 24, 24, 8, 0, "bfloat16"),
])
def test_flash_backward_matches_reference_vjp(causal, Sq, Skv, block, unfilled, dtype):
    jx, tx, q_pos, kv_pos = _flash_inputs(0, Sq, Skv, 4, dtype=dtype, unfilled=unfilled)
    out, vjp = jax.vjp(lambda q, k, v: jll._flash(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal, block),
                       *jx[:3])
    want = (out,) + vjp(jx[3])
    got = _port_vjp(lambda q, k, v: ll._Flash.apply(q, k, v, torch.from_numpy(q_pos),
                                                    torch.from_numpy(kv_pos), causal, block), tx)
    rel = 1e-2 if dtype == "bfloat16" else 1e-5
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == tx[0].dtype, (name, g.dtype)
        close(g, w, rel, name)


@pytest.mark.parametrize("H,KV,causal", [(8, 2, True), (4, 1, False), (4, 4, True)])
def test_attn_core_backward_gqa_matches_reference(H, KV, causal):
    """Through ``_attn_core``: the GQA repeat lies outside the Function, so
    autograd sums each group's dk/dv, as ``jnp.repeat``'s VJP does."""
    jx, tx, q_pos, kv_pos = _flash_inputs(1, S, S, H, KV=KV)
    out, vjp = jax.vjp(lambda q, k, v: jll._attn_core(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal),
                       *jx[:3])
    want = (out,) + vjp(jx[3])
    got = _port_vjp(lambda q, k, v: ll._attn_core(q, k, v, torch.from_numpy(q_pos),
                                                  torch.from_numpy(kv_pos), causal), tx)
    assert got[2].shape == (B, S, KV, 16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        close(g, w, 1e-5, name)


def test_flash_saves_no_tiles():
    """The forward keeps the reference's residuals only: inputs, output and
    log-sum-exp, nothing of the per-block (Sq, kv_block) tiles."""
    _, tx, q_pos, kv_pos = _flash_inputs(2, 32, 32, 4)
    q, k, v = (t.requires_grad_() for t in tx[:3])
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        ll._Flash.apply(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos), True, 8)
    assert sorted(saved) == sorted([(B, 32, 4, 16)] * 4 + [(B, 32)] * 2 + [(B, 32, 4)])


# ------------------------------------------------------------- every arch
@functools.cache
def reference(arch):
    """The reference's weights, and its loss and gradients on one batch."""
    cfg = jget_config(arch).reduced()
    model = jbuild(cfg)
    params = jinit(model.param_specs(), jax.random.PRNGKey(0))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, jbatch(cfg, "train_4k", S, B, None))
    return dict(params=jax.tree.map(np.asarray, params), loss=float(loss), grads=jax.tree.map(np.asarray, grads))


def port_loss_and_grads(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    model.load_state_dict(params_from_reference(cfg, reference(arch)["params"]), strict=True, assign=True)
    leaves = dict(model.named_parameters())
    loss = model.loss(materialize_batch(cfg, "train_4k", S, B))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return cfg, loss, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    cfg, loss, grads = port_loss_and_grads(arch)
    ref = reference(arch)
    rel = REL_ENCDEC if cfg.family == "encdec" else REL
    close(loss, np.float32(ref["loss"]), REL, "loss")
    got = params_to_reference(cfg, grads)
    want_leaves = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert jax.tree.structure(got) == jax.tree.structure(ref["grads"])
    for (path, want), g in zip(want_leaves, jax.tree.leaves(got)):
        close(g, want, rel, f"grad {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_changes_no_bit(arch, monkeypatch):
    """``loss`` recomputes each layer (or xLSTM/Zamba2 group, and each
    sLSTM chunk of a longer sequence) in the backward; with the recompute
    off the loss and gradients are the same bits."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    cfg, loss, grads = port_loss_and_grads(arch)
    groups = {"ssm": cfg.n_layers // max(cfg.slstm_every, 1),
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(cfg.family, cfg.n_layers)
    assert len(calls) >= groups, (len(calls), groups)  # recompute per layer/group at least
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda fn, *args, **kw: fn(*args))
    _, loss0, grads0 = port_loss_and_grads(arch)
    assert torch.equal(loss, loss0)
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k


def test_slstm_chunks_recomputed_under_train(monkeypatch):
    """A sequence longer than the sLSTM's chunk recomputes each chunk of Q
    steps (the reference's checkpointed chunk body); the same gradients."""
    from repro_torch.models import ssm
    from repro_torch.models.common import init_params

    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn) or real(fn, *a, **kw))
    cfg = get_config("xlstm_125m").reduced()
    gen = torch.Generator().manual_seed(0)
    p = init_params(ssm.slstm_specs(cfg), gen)
    x = torch.randn(B, 96, cfg.d_model, generator=gen).requires_grad_()
    assert ssm.slstm_chunk_len(96) == 32
    out = {}
    for train in (False, True):
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        y, _ = ssm.slstm(ps, x, cfg, train=train)
        out[train] = (y, torch.autograd.grad(y.square().sum(), [x] + list(ps.values())))
    assert len(calls) == 3  # 96 steps, three chunks of 32, each recomputed
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def _float64_grads(cfg, state, batch, monkeypatch):
    """The port's loss gradients with every float32 step in float64: the
    parameters, the batch and each ``.float()``/float32 allocation widened.
    A float64 evaluation to measure float32 rounding against."""
    import repro_torch.models.ssm_models as ssm_models

    def widen(fn):
        def wrapped(*args, **kw):
            if kw.get("dtype") == torch.float32:
                kw["dtype"] = torch.float64
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(torch.Tensor, "float", lambda self: self.double())
    monkeypatch.setattr(torch, "zeros", widen(torch.zeros))
    monkeypatch.setattr(torch, "full", widen(torch.full))
    real_init = ssm_models.init_params
    monkeypatch.setattr(ssm_models, "init_params", lambda *a, **kw: {
        k: {n: t.double() if t.dtype == torch.float32 else t for n, t in v.items()}
        for k, v in real_init(*a, **kw).items()})
    model = build_model(dataclasses.replace(cfg, dtype="float64"))
    model.load_state_dict({k: v.double() for k, v in state.items()}, strict=True, assign=True)
    leaves = dict(model.named_parameters())
    loss = model.loss({k: v.double() if v.is_floating_point() else v for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    monkeypatch.undo()
    return dict(zip(leaves, grads))


def _gap(grads, truth) -> float:
    """The largest float32 error of a leaf, as a share of max(1, its max)."""
    return max(float((grads[k].double() - t).abs().max()) / max(1.0, float(t.abs().max())) for k, t in truth.items())


@pytest.mark.parametrize("arch,full", [("seamless_m4t_v2", False), ("xlstm_125m", True)])
def test_float32_gradients_near_float64(arch, full, monkeypatch):
    """How far float32 gradients lie from a float64 evaluation, the basis of
    two tolerances: the encdec's here (the reference's and the port's
    float32 gradients each within 1e-3 of float64 on the reduced config, so
    within about that of each other) and the xLSTM's in ``chip_smoke.py``
    phase 12c. There each side's float32 gradients, at full width and the
    family's fewest layers, are held within 1.5e-3 of float64, the bound
    here; the CPU's lie 4.65e-4 away and the card's 7.25e-4, on the same
    leaf (groups.0.mlstm.1.w_if) and on opposite sides, so the card and the
    CPU differ by up to their sum (1.19e-3 measured), within the 3e-3 that
    two such distances allow. ``-s`` prints the gaps."""
    if full:  # phase 12c's cut: one xLSTM group (slstm_every layers) at full width
        full_cfg = get_config(arch)
        cfg = dataclasses.replace(full_cfg, n_layers=full_cfg.slstm_every, dtype="float32")
        from repro_torch.models.common import init_params

        state = params_from_reference(cfg, init_params(build_model(cfg).param_specs(),
                                                       torch.Generator().manual_seed(0)))
        bound = 1.5e-3
    else:
        cfg = get_config(arch).reduced()
        state = params_from_reference(cfg, reference(arch)["params"])
        bound = REL_ENCDEC
    batch = materialize_batch(cfg, "train_4k", S, B)
    model = build_model(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    leaves = dict(model.named_parameters())
    g32 = dict(zip(leaves, torch.autograd.grad(model.loss(batch), list(leaves.values()))))
    truth = _float64_grads(cfg, state, batch, monkeypatch)
    gaps = {"port": _gap(g32, truth)}
    if not full:
        ref = {k: torch.from_numpy(np.asarray(v)) for k, v in params_from_reference(
            cfg, reference(arch)["grads"]).items()}
        gaps["reference"] = _gap(ref, truth)
    print(f"{arch} ({cfg.n_layers} layers, d_model {cfg.d_model}): float32 gradients against float64, "
          f"largest error / scale {gaps}")
    assert all(0 < g <= bound for g in gaps.values()), gaps
