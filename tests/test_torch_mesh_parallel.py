"""The mesh building blocks of the LM scaffold, port against the JAX package.

- ``_moe_sharded`` (``moe_ffn(..., mesh=)``) against the reference's
  ``moe_ffn`` under ``set_mesh`` on (1, 1), (2, 1), (1, 2) and (2, 2)
  data×model meshes at capacity factors 1.25 and 4.0: granite_moe's reduced
  config, batch (4, 8), float32; output and aux loss within 1e-5 of
  max(1, max|reference|) (float32 rounding: the routing is exact, the sums
  over experts and shards run in the reference's order).
- ``gpipe_forward`` on the reference's own case (8 layers, 4 stages, 6
  microbatches) within its 2e-5, against the reference and a sequential run.
- ``compressed_psum`` bit for bit, with the reference's own uniform noise,
  including shards whose scales differ.

The reference runs once per module in a subprocess with 8 host devices and
writes its results to an ``.npz``; the port's meshes put every position on
``"cpu"``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import _moe_axes, _moe_dense, moe_ffn
from repro_torch.training.compress import compressed_psum
from repro_torch.training.pipeline import gpipe_forward

SRC = str(Path(__file__).resolve().parents[1] / "src")
MOE_MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
FACTORS = [1.25, 4.0]
TOL = 1e-5

_REF = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, set_mesh, shard_map
    from repro.configs.base import get_config
    from repro.models.common import init_params
    from repro.models.moe import moe_ffn, moe_specs
    from repro.training.compress import compressed_psum
    from repro.training.pipeline import gpipe_forward

    meshes, factors, psum_cases = json.loads(sys.argv[2])
    out = {}

    # _moe_sharded under an ambient mesh (tests/test_perf_paths.py's set-up)
    base = get_config("granite_moe").reduced()
    p = init_params(moe_specs(base), jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, base.d_model), jnp.float32)
    out["moe/x"] = np.asarray(x)
    for k, v in p.items():
        out[f"moe/p/{k}"] = np.asarray(v)
    for cf in factors:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        for shape in meshes:
            with set_mesh(make_mesh(tuple(shape), ("data", "model"))):
                o, aux = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(p, x)
            out[f"moe/{cf}/{shape[0]}x{shape[1]}/out"] = np.asarray(o)
            out[f"moe/{cf}/{shape[0]}x{shape[1]}/aux"] = np.asarray(aux)

    # tests/test_pipeline.py's case
    mesh = make_mesh((4,), ("pipe",))
    L, D, n_micro, mb = 8, 16, 6, 4
    rng = np.random.default_rng(0)
    ws = jnp.asarray(rng.normal(size=(L, D, D)) / np.sqrt(D), jnp.float32)
    bs = jnp.asarray(rng.normal(size=(L, D)) * 0.1, jnp.float32)
    xp = jnp.asarray(rng.normal(size=(n_micro, mb, D)), jnp.float32)
    layer = lambda lp, h: jnp.tanh(h @ lp[0] + lp[1])
    got = jax.jit(lambda p, x: gpipe_forward(layer, p, x, mesh=mesh))((ws, bs), xp)
    out.update({"pipe/ws": np.asarray(ws), "pipe/bs": np.asarray(bs), "pipe/x": np.asarray(xp),
                "pipe/out": np.asarray(got)})

    # compressed_psum over a data axis, one shard a position; the key is
    # replicated, so every shard draws the same noise
    for name, shards, seed in psum_cases:
        if shards is None:
            g = np.random.default_rng(3).normal(size=(4, 64, 4, 16))
            shards = g * np.array([1, 0.5, 2, 0.01])[:, None, None, None]
        xs = jnp.asarray(np.asarray(shards, np.float32))
        n = xs.shape[0]
        key = jax.random.PRNGKey(seed)
        f = shard_map(lambda xb: compressed_psum(xb[0], "data", key)[None], mesh=make_mesh((n,), ("data",)),
                      in_specs=P("data"), out_specs=P("data"))
        res = np.asarray(jax.jit(f)(xs))
        assert all(np.array_equal(res[0], r) for r in res)
        out[f"psum/{name}/out"] = res[0]
        out[f"psum/{name}/noise"] = np.asarray(jax.random.uniform(key, xs.shape[1:], jnp.float32) - 0.5)
        out[f"psum/{name}/x"] = np.asarray(xs)
    np.savez(sys.argv[1], **out)
    """
)

PSUM_CASES = [  # name, the shards (None: four of reduced tinyllama's wq shape, scales 1, 0.5, 2, 0.01), key
    ["four_shards", None, 0],
    ["scales_differ", [[1.0, 0.5], [0.01, 0.01]], 0],
    ["zeros_and_one", [[0.0, 0.0, 0.0], [0.0, 3.0, -1.5]], 7],
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tensors here are small: one intra-op thread keeps the test
    workers that run beside this module from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_parallel_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    args = json.dumps([MOE_MESHES, FACTORS, PSUM_CASES])
    out = subprocess.run([sys.executable, "-c", _REF, str(path), args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


def close(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * scale, f"{what}: max abs error {err} > {TOL} x {scale}"


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_sharded_matches_reference(ref, shape, cf):
    cfg = dataclasses.replace(get_config("granite_moe").reduced(), capacity_factor=cf)
    p = {k[len("moe/p/"):]: torch.from_numpy(v) for k, v in ref.items() if k.startswith("moe/p/")}
    x = torch.from_numpy(ref["moe/x"])
    mesh = cpu_mesh(shape, ("data", "model"))
    assert _moe_axes(cfg, x.shape[0], mesh) == (("data",), "model", shape[0], shape[1])
    out, aux = moe_ffn(p, x, cfg, mesh=mesh)
    tag = f"moe/{cf}/{shape[0]}x{shape[1]}"
    close(out, ref[f"{tag}/out"], f"{tag} out")
    close(aux, ref[f"{tag}/aux"], f"{tag} aux")
    if shape[0] == 1:  # one data shard: the sharded path is the dense path
        d_out, d_aux = _moe_dense(p, x, cfg)
        close(out, d_out.numpy(), "dense out")
        close(aux, d_aux.numpy(), "dense aux")


def test_moe_axes_fallbacks():
    """The dense path where the mesh cannot take the sharded one: no mesh,
    no model axis, experts or batch indivisible."""
    cfg = get_config("granite_moe").reduced()  # 4 experts
    assert _moe_axes(cfg, 4, None) is None
    assert _moe_axes(cfg, 4, cpu_mesh((2,), ("data",))) is None
    assert _moe_axes(cfg, 4, cpu_mesh((1, 8), ("data", "model"))) is None  # 4 experts on 8
    assert _moe_axes(cfg, 3, cpu_mesh((2, 2), ("data", "model"))) is None  # batch 3 on 2
    assert _moe_axes(cfg, 4, cpu_mesh((2, 2, 2), ("pod", "data", "model"))) == (("pod", "data"), "model", 4, 2)
    assert _moe_axes(cfg, 4, cpu_mesh((4,), ("model",))) == ((), "model", 1, 4)


# --------------------------------------------------------------- pipeline
def _layer(lp, h):
    w, b = lp
    return torch.tanh(h @ w + b)


@pytest.mark.parametrize("stages", [4, 2, 1])
def test_gpipe_matches_reference_and_sequential(ref, stages):
    ws, bs, x = (torch.from_numpy(ref[f"pipe/{k}"]) for k in ("ws", "bs", "x"))
    got = gpipe_forward(_layer, (ws, bs), x, mesh=cpu_mesh((stages,), ("pipe",)))
    h = x
    for i in range(ws.shape[0]):
        h = _layer((ws[i], bs[i]), h)
    np.testing.assert_allclose(got.numpy(), h.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref["pipe/out"], rtol=2e-5, atol=2e-5)


def test_gpipe_refuses_uneven_splits():
    ws = torch.zeros(6, 4, 4)
    with pytest.raises(ValueError, match="do not split"):
        gpipe_forward(_layer, (ws, torch.zeros(6, 4)), torch.zeros(4, 2, 4), mesh=cpu_mesh((4,), ("pipe",)))
    with pytest.raises(ValueError, match="microbatches"):
        gpipe_forward(_layer, (ws, torch.zeros(6, 4)), torch.zeros(2, 2, 4), mesh=cpu_mesh((3,), ("pipe",)))


# ------------------------------------------------------- compressed psum
@pytest.mark.parametrize("case", [c[0] for c in PSUM_CASES])
def test_compressed_psum_matches_reference(ref, case):
    xs = torch.from_numpy(ref[f"psum/{case}/x"])
    noise = torch.from_numpy(ref[f"psum/{case}/noise"])
    got = compressed_psum(list(xs), [noise] * xs.shape[0])
    want = ref[f"psum/{case}/out"]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want), (got, want)
    if case == "scales_differ":
        # the reference's formula: the integer sum dequantized with the
        # largest scale overweights the small shard (the true sum is [1.01, 0.51])
        np.testing.assert_allclose(want, [2.0, 1.504], atol=5e-4)
