"""Every architecture of the LM scaffold, port against the JAX package.

Reduced configs (2-4 layers, width 64, float32), the reference's weights
carried across by ``repro_torch.models.convert``. The reference runs as its
own tests run it: ``jax.jit`` of ``prefill``/``decode`` on the CPU, one
compile a shape, shared by every test of an arch in this module.

Tolerance (float32): every compared float leaf within 1e-4 × max(1,
max|reference|). The two packages contract in other orders (einsum paths,
BLAS blocking), so they differ by float32 rounding: the largest seen is
1.6e-5 of the scale (Zamba2's decode logits), 6× inside the bound. Integer
leaves (cache positions) are equal. The bfloat16 case uses 5e-2 of the
scale: bfloat16 keeps 8 significant bits (1 ulp is 0.8% near 3.3, the
logits' largest magnitude), XLA fuses elementwise chains in float32 where
PyTorch rounds each op to bfloat16, and so the two differ by a few ulps
(0.02 seen, 1.5 ulps), as far as each lies from its own float32 result.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.models.common import init_params as jinit
from repro.models.common import n_params as jn_params
from repro.models.registry import SHAPES as JSHAPES
from repro.models.registry import applicable as japplicable
from repro.models.registry import batch_specs as jbatch_specs
from repro.models.registry import build_model as jbuild
from repro.models.registry import cache_specs_for as jcache_specs_for
from repro.models.registry import materialize_batch as jbatch
from repro_torch.configs.base import get_config
from repro_torch.models.common import init_params, n_params
from repro_torch.models.convert import (
    cache_from_reference,
    cache_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.registry import (
    SHAPES,
    applicable,
    batch_specs,
    build_model,
    cache_specs_for,
    load_model,
    materialize_batch,
    step_fn,
)

S, B, CACHE = 24, 2, 32  # prefill length, batch, cache slots
REL = {"float32": 1e-4, "bfloat16": 5e-2}


def close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs error {err} > {rel} x {scale}"


def close_tree(got: dict, want: dict, rel, what=""):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            close_tree(got[k], want[k], rel, f"{what}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, (f"{what}/{k}", got[k].dtype, want[k].dtype)
            close(got[k], want[k], rel, f"{what}/{k}")


def configs(arch, dtype="float32"):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@functools.cache
def reference(arch, dtype="float32"):
    """The reference's weights, fresh cache, prefill and one decode step."""
    cfg, _ = configs(arch, dtype)
    model = jbuild(cfg)
    params = jinit(model.param_specs(), jax.random.PRNGKey(0))
    cache = jinit(jcache_specs_for(cfg, "decode_32k", seq=CACHE, batch=B), jax.random.PRNGKey(1))
    batch = jbatch(cfg, "prefill_32k", S, B, None)
    logits, cache1 = jax.jit(model.prefill)(params, batch, cache)
    dec = {"token": jnp.full((B, 1), 3, jnp.int32), "pos": jnp.asarray(S, jnp.int32)}
    logits2, cache2 = jax.jit(model.decode)(params, dec, cache1)
    to_np = functools.partial(jax.tree.map, lambda a: np.asarray(a.astype(jnp.float32))
                              if a.dtype == jnp.bfloat16 else np.asarray(a))
    return dict(params=jax.tree.map(np.asarray, params), cache=to_np(cache), logits=to_np(logits),
                cache1=to_np(cache1), logits2=to_np(logits2), cache2=to_np(cache2))


def port_model(arch, dtype="float32"):
    _, cfg = configs(arch, dtype)
    return cfg, load_model(cfg, params_from_reference(cfg, reference(arch, dtype)["params"]), "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_converter_round_trips_key_for_key(arch):
    _, cfg = configs(arch)
    tree = reference(arch)["params"]
    state = params_from_reference(cfg, tree)
    assert sorted(state) == sorted(build_model(cfg).state_dict())
    back = params_to_reference(cfg, state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    # the reference's stacked leaf (L, ...) is one tensor a layer here
    key = {"ssm": "groups.0.mlstm.0.up", "hybrid": "groups.0.mamba.0.in_proj",
           "encdec": "decoder.1.self_attn.wq"}.get(cfg.family, "layers.1.attn.wq")
    path = {"ssm": ("groups", "mlstm", "up"), "hybrid": ("groups", "mamba", "in_proj"),
            "encdec": ("decoder", "self_attn", "wq")}.get(cfg.family, ("layers", "attn", "wq"))
    idx = {"ssm": (0, 0), "hybrid": (0, 0), "encdec": (1,)}.get(cfg.family, (1,))
    leaf = tree
    for k in path:
        leaf = leaf[k]
    np.testing.assert_array_equal(state[key].numpy(), leaf[idx])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    cfg, model = port_model(arch)
    ref = reference(arch)
    cache = init_params(cache_specs_for(cfg, "decode_32k", seq=CACHE, batch=B))
    close_tree(cache_to_reference(cache), ref["cache"], 0.0, "fresh cache")  # the sentinels
    with torch.inference_mode():
        logits, cache1 = model.prefill(materialize_batch(cfg, "prefill_32k", S, B), cache)
        close(logits, ref["logits"], REL["float32"], "prefill logits")
        close_tree(cache_to_reference(cache1), ref["cache1"], REL["float32"], "prefill cache")
        # one decode step from the reference's own prefill cache
        dec = {"token": torch.full((B, 1), 3, dtype=torch.int32), "pos": S}
        logits2, cache2 = model.decode(dec, cache_from_reference(ref["cache1"]))
    close(logits2, ref["logits2"], REL["float32"], "decode logits")
    close_tree(cache_to_reference(cache2), ref["cache2"], REL["float32"], "decode cache")
    assert logits2.shape == (B, 1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_consistent_with_full_prefill(arch):
    """Prefill of S tokens against prefill of S-1 then one decode step, at
    the reference's own tolerance (``test_decode_consistency_with_full_forward``,
    2e-3). MoE archs run with ``capacity_factor = E / k`` here: a capacity
    that drops nothing, since a dropped pair changes its token's output by
    design and the decode step's capacity (T = B tokens) differs from the
    prefill's."""
    cfg, model = port_model(arch)
    if cfg.n_experts:
        model.cfg = cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    batch = materialize_batch(cfg, "train_4k", S, B)
    tokens = batch["tokens"]
    n = tokens.shape[1] - 1  # the prompt's tokens (the VLM's follow its patches)
    specs = cache_specs_for(cfg, "decode_32k", seq=S + 8, batch=B)
    with torch.inference_mode():
        full, _ = model.prefill({**batch, "tokens": tokens[:, :n]}, init_params(specs))
        _, cache = model.prefill({**batch, "tokens": tokens[:, :n - 1]}, init_params(specs))
        step, _ = model.decode({"token": tokens[:, n - 1:n], "pos": S - 1}, cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 0].numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_through_step_fn_matches_reference(arch):
    """``step_fn(cfg, "train_4k")`` runs the model's ``loss`` over a state
    mapping (``torch.func.functional_call``): the reference's loss, forward
    only, MoE aux term included."""
    jcfg, cfg = configs(arch)
    params = reference(arch)["params"]
    jmodel = jbuild(jcfg)
    want = jax.jit(jmodel.loss)(jax.tree.map(jnp.asarray, params), jbatch(jcfg, "train_4k", S, B, None))
    state = params_from_reference(cfg, params)
    got = step_fn(cfg, "train_4k")(state, materialize_batch(cfg, "train_4k", S, B))
    assert got.shape == () and torch.isfinite(got)
    close(got.detach(), np.asarray(want), REL["float32"], "loss")


def _spec_table(tree):
    """{path: (shape, dtype name)} of a ParamSpec tree from either package."""
    out = {}
    for k, v in (tree or {}).items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": t for p, t in _spec_table(v).items()})
        else:
            dt = v.dtype
            out[k] = (tuple(v.shape), str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
                      else np.dtype(dt).name)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_tables_match_reference(arch):
    """At the full config (specs only): the same applicability, batch and
    cache shapes and dtypes for every shape cell."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert SHAPES == JSHAPES
    for shape in SHAPES:
        assert applicable(cfg, shape) == japplicable(jcfg, shape)
        assert _spec_table(batch_specs(cfg, shape)) == _spec_table(jbatch_specs(jcfg, shape))
        assert _spec_table(cache_specs_for(cfg, shape)) == _spec_table(jcache_specs_for(jcfg, shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count_equals_reference(arch):
    cfg = get_config(arch)
    want = jn_params(jbuild(jget_config(arch)).param_specs())
    model = build_model(cfg)  # on the meta device: nothing allocated
    assert n_params(model.param_specs()) == want
    assert sum(p.numel() for p in model.parameters()) == want


def test_bfloat16_tinyllama_matches_reference():
    cfg, model = port_model("tinyllama_1_1b", "bfloat16")
    ref = reference("tinyllama_1_1b", "bfloat16")
    with torch.inference_mode():
        logits, cache1 = model.prefill(materialize_batch(cfg, "prefill_32k", S, B),
                                       init_params(cache_specs_for(cfg, "decode_32k", seq=CACHE, batch=B)))
        assert logits.dtype == torch.bfloat16
        dec = {"token": torch.full((B, 1), 3, dtype=torch.int32), "pos": S}
        logits2, _ = model.decode(dec, cache1)
    close(logits.float(), ref["logits"], REL["bfloat16"], "bf16 prefill logits")
    close(logits2.float(), ref["logits2"], REL["bfloat16"], "bf16 decode logits")
