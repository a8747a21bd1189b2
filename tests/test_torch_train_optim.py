"""The optimizer, gradient compression and prefetcher, port against the JAX
package.

AdamW runs on identical parameters, gradients and moments in both packages
and is held within a few float32 ulps: XLA's CPU fusion may contract a
multiply-add or evaluate ``pow`` an ulp apart, so every compared value is
within 4 ulps of its magnitude (``ULPS``). The schedule is held the same
way. The int8 quantizer is bit for bit on the reference's own noise; the
port's noise comes from a ``torch.Generator``, so its compression is held to
the reference's properties (unbiased, within one scale step, error feedback
exact) rather than to its draws.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compress as jgc
from repro.training import optim as joptim
from repro_torch.data.pipeline import Prefetcher
from repro_torch.training import compress as gc
from repro_torch.training.optim import OptConfig, adamw_update, global_norm, init_opt_state, schedule

ULPS = 4 * np.finfo(np.float32).eps


def ulp_close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype)
    np.testing.assert_allclose(got, want, rtol=ULPS, atol=0, err_msg=what)


@pytest.mark.parametrize("cfg", [OptConfig(), OptConfig(lr=1e-3, warmup_steps=3, total_steps=30),
                                 OptConfig(lr=2e-3, warmup_steps=0, total_steps=1, min_lr_frac=0.0)])
def test_schedule_matches_reference(cfg):
    jcfg = joptim.OptConfig(**vars(cfg))
    for step in itertools.chain(range(0, 40), (99, 100, 101, 5_000, 9_999, 10_000, 20_000)):
        want = joptim.schedule(jcfg, jnp.asarray(step, jnp.int32))
        got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        ulp_close(got, want, f"step {step}")


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (64,), "c": (3, 4, 6), "d": (1,)}
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in sorted(shapes.items())}


@pytest.mark.parametrize("grad_scale,clipped", [(1e-2, False), (10.0, True)])
def test_adamw_update_matches_reference(grad_scale, clipped):
    """One step from moments of an earlier step (bias correction at step
    6), on identical gradients, clip active or not."""
    cfg = OptConfig(lr=1e-3, warmup_steps=3, total_steps=30)
    p, g = _tree(0), _tree(1, grad_scale)
    m, v = _tree(2, 0.01), {k: np.abs(a) for k, a in _tree(3, 0.01).items()}
    step = np.asarray(5, np.int32)
    jp, jst, jmet = joptim.adamw_update(
        joptim.OptConfig(**vars(cfg)), p, g, {"m": m, "v": v, "step": jnp.asarray(step)})
    T = lambda t: {k: torch.from_numpy(a.copy()) for k, a in t.items()}  # noqa: E731
    tp, tst = T(p), {"m": T(m), "v": T(v), "step": torch.from_numpy(step.copy())}
    new_p, new_st, met = adamw_update(cfg, tp, T(g), tst)
    assert new_p is tp and new_st["m"] is tst["m"]  # updated in place
    assert bool(met["grad_norm"] > cfg.grad_clip) == clipped
    ulp_close(met["grad_norm"], jmet["grad_norm"], "grad_norm")
    ulp_close(met["lr"], jmet["lr"], "lr")
    assert int(new_st["step"]) == int(jst["step"]) == 6
    for k in p:
        ulp_close(new_st["m"][k], jst["m"][k], f"m/{k}")
        ulp_close(new_st["v"][k], jst["v"][k], f"v/{k}")
        # p moves by about lr; its own rounding is an ulp of p
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(jp[k]), rtol=ULPS, atol=ULPS * cfg.lr, err_msg=k)


def test_init_opt_state_and_global_norm():
    p = {k: torch.from_numpy(a) for k, a in _tree(0).items()}
    st = init_opt_state(p)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    assert all(st["m"][k].dtype == torch.float32 and not st["m"][k].any() for k in p)
    assert st["m"]["a"] is not st["v"]["a"]
    want = joptim.global_norm({k: a.numpy() for k, a in p.items()})
    ulp_close(global_norm(p.values()), want, "global_norm")


@pytest.mark.parametrize("seed,shape,scale", [(0, (512,), 1.0), (1, (33, 17), 1e-3), (2, (4, 8, 16), 50.0)])
def test_int8_quantize_bit_for_bit_on_reference_noise(seed, shape, scale):
    g = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    q_ref, s_ref = jgc.int8_compress(jnp.asarray(g), key)
    noise = np.asarray(jax.random.uniform(key, g.shape, jnp.float32)) - np.float32(0.5)
    q, s = gc.int8_quantize(torch.from_numpy(g), torch.from_numpy(noise))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.item() == float(s_ref)
    np.testing.assert_array_equal(gc.int8_decompress(q, s).numpy(), np.asarray(jgc.int8_decompress(q_ref, s_ref)))


def test_int8_compression_unbiased_and_bounded():
    """The reference's test on the port's generator."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(512,)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    deqs = []
    for _ in range(50):
        q, s = gc.int8_compress(g, gen)
        deqs.append(gc.int8_decompress(q, s))
    err = torch.stack(deqs).mean(0) - g
    assert err.abs().max() < 0.01  # stochastic rounding is unbiased
    assert (deqs[0] - g).abs().max() <= float(s) * 1.01  # one scale step


@pytest.mark.parametrize("g,frac", [([0.1, -5.0, 0.2, 3.0, -0.05], 0.4), (None, 0.05), (None, 0.5)])
def test_topk_matches_reference(g, frac):
    g = np.asarray(g, np.float32) if g is not None else \
        np.random.default_rng(3).normal(size=(20, 30)).astype(np.float32)
    want = np.asarray(jgc.topk_compress(jnp.asarray(g), frac))
    got = gc.topk_compress(torch.from_numpy(g), frac).numpy()
    np.testing.assert_array_equal(got, want)


def test_error_feedback_topk_matches_reference():
    """Top-k with feedback draws no noise: the delivered gradients and
    residuals equal the reference's over 30 steps."""
    rng = np.random.default_rng(1)
    true = [{"g": rng.normal(size=(64,)).astype(np.float32), "h": rng.normal(size=(4, 8)).astype(np.float32)}
            for _ in range(30)]
    jres = jgc.init_residuals(true[0])
    res = gc.init_residuals({k: torch.from_numpy(a) for k, a in true[0].items()})
    for i, g in enumerate(true):
        jout, jres = jgc.compress_with_feedback(g, jres, jax.random.PRNGKey(i), "topk", 0.1)
        out, res = gc.compress_with_feedback({k: torch.from_numpy(a) for k, a in g.items()}, res, None, "topk", 0.1)
        for k in g:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=f"step {i} {k}")
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]), err_msg=f"step {i} {k}")


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_accumulates(scheme):
    """With feedback, the sum of delivered grads tracks the sum of true
    grads: the total error is the final residual (the reference's test)."""
    rng = np.random.default_rng(1)
    true = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) for _ in range(30)]
    res = gc.init_residuals({"g": true[0]})
    gen = torch.Generator().manual_seed(0)
    delivered = []
    for g in true:
        out, res = gc.compress_with_feedback({"g": g}, res, gen, scheme, 0.1)
        delivered.append(out["g"])
    total_err = torch.stack(delivered).sum(0) - torch.stack(true).sum(0)
    np.testing.assert_allclose(total_err.numpy(), -res["g"].numpy(), rtol=1e-4, atol=1e-4)


def test_int8_feedback_draws_once_a_leaf_in_order():
    """One uniform draw a leaf, in the grads' order, from the generator."""
    grads = {"b": torch.ones(5), "a": torch.full((3,), -2.0)}
    res = gc.init_residuals(grads)
    out, _ = gc.compress_with_feedback(grads, res, torch.Generator().manual_seed(7), "int8")
    gen = torch.Generator().manual_seed(7)
    for k, g in grads.items():
        q, s = gc.int8_compress(g, gen)
        assert torch.equal(out[k], gc.int8_decompress(q, s)), k
    with pytest.raises(ValueError):
        gc.compress_with_feedback(grads, res, gen, "fp4")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_overlap_and_skip(device):
    """The reference's ``test_prefetcher_overlap_and_skip``; with a device,
    batches arrive as tensors there."""
    gen = ({"i": np.asarray(i)} for i in itertools.count())
    pf = Prefetcher(gen, depth=4, device=device)
    first = pf.next()["i"]
    assert isinstance(first, torch.Tensor) == (device is not None)
    pf.skip_slow(2)
    later = pf.next()["i"]
    assert later > first
    assert pf.skipped == 2
    pf.close()
