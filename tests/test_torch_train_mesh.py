"""The LM scaffold's training over a mesh, port against the JAX package.

- Sharding rules: every leaf's ``PartitionSpec`` of every arch's
  ``param_specs()``, ``batch_specs``, ``cache_specs_for`` and ZeRO-1
  ``moment_specs`` (full and reduced configs) equal to the reference's, on
  (4, 2) data×model, (2, 2, 2) pod×data×model and (1, 16), with the
  fallbacks the rules name (xlstm's 4 heads on 16, an indivisible vocab).
- The ZeRO-1 step: the mesh step equals the one-device step bit for bit
  (loss, parameters, m and v) for every arch at the reduced config, over 4
  steps; ``launch.train --mesh 2x1`` resumed from the reference's ``--mesh
  2x1`` checkpoint against the reference's run, losses within 1e-4 ×
  max(1, |loss|) (the one-device tolerance of ``test_torch_train_loop.py``).
- Checkpoints: saves gather the moments (the reference's manager reads
  them), and a restore splits them onto another mesh or onto none and the
  run continues bit for bit (the reference's elastic restore).

The reference needs one JAX device per mesh position, which the JAX runtime
fixes when it starts, so it runs once per module in a subprocess with 16
host devices and writes its results as JSON. The port's meshes put every
position on ``"cpu"``.
"""
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

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data import corpus
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh, make_mesh_from_spec
from repro_torch.models.common import param_specs_pspec
from repro_torch.models.convert import train_state_from_reference
from repro_torch.models.registry import SHAPES, batch_specs, build_model, cache_specs_for, materialize_batch
from repro_torch.sharding import MeshRules, NamedSharding, PartitionSpec, Sharded, logical_to_spec
from repro_torch.training.optim import OptConfig, moment_specs
from repro_torch.training.step import TrainConfig, make_train_state, make_train_step, moment_shardings
from repro_torch.training.trainer import LoopConfig, Trainer

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x16": ((1, 16), ("data", "model"))}
# (logical axes, shape) the rules' fallbacks turn on
LOGICAL = [
    [["vocab", "embed"], [256206, 1024]],  # seamless' vocab before padding: divides neither 2 nor 16
    [["heads", None], [4, 64]],  # xlstm's 4 heads: on 2, not on 16
    [["batch", "seq"], [8, 128]],
    [["batch", "heads"], [6, 16]],  # 6 rows on pod×data = 4: falls back to data alone
    [["experts", "ff", "embed"], [32, 64, 16]],
    [["kv_heads", "heads"], [16, 32]],  # model taken by the first
]
STEPS = 6

_REF = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import jax
    from repro.compat import make_mesh
    from repro.configs.base import ARCH_IDS, get_config
    from repro.launch import train
    from repro.models.common import ParamSpec, param_specs_pspec
    from repro.models.registry import SHAPES, batch_specs, build_model, cache_specs_for
    from repro.sharding.rules import MeshRules, logical_to_spec
    from repro.training.optim import moment_specs

    meshes, logical, steps, ckpt = json.loads(sys.argv[2])

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(flat(tree[k], f"{prefix}{k}/"))
            return out
        return {prefix[:-1]: [entry(e) for e in tree]}

    specs = {}
    for name, (shape, axes) in meshes.items():
        rules = MeshRules(make_mesh(tuple(shape), tuple(axes)))
        out = specs[name] = {"logical": [[entry(e) for e in logical_to_spec(rules.mesh, tuple(a), tuple(s))]
                                         for a, s in logical]}
        for arch in ARCH_IDS:
            for cut in ("full", "reduced"):
                cfg = get_config(arch) if cut == "full" else get_config(arch).reduced()
                ps = build_model(cfg).param_specs()
                tree = {"params": ps, "moments": moment_specs(ps, rules), "batch": {}, "cache": {}}
                for shape in SHAPES:
                    tree["batch"][shape] = batch_specs(cfg, shape)
                    cache = cache_specs_for(cfg, shape)
                    if cache is not None:
                        tree["cache"][shape] = cache
                out[f"{arch}/{cut}"] = flat(param_specs_pspec(tree, rules))

    # launch.train --mesh 2x1 on the reduced tinyllama
    hist = train.main(["--arch", "tinyllama_1_1b", "--reduced", "--steps", str(steps), "--batch", "2",
                       "--seq", "32", "--mesh", "2x1", "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    json.dump({"specs": specs, "losses": [h["loss"] for h in hist]}, open(sys.argv[1], "w"))
    """
)


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
    d = tmp_path_factory.mktemp("train_mesh_ref")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    args = json.dumps([MESHES, LOGICAL, STEPS, str(d / "ckpt")])
    out = subprocess.run([sys.executable, "-c", _REF, str(d / "ref.json"), args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(json.loads((d / "ref.json").read_text()), ckpt=str(d / "ckpt"))


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    assert isinstance(tree, PartitionSpec), tree
    return {prefix[:-1]: [_entry(e) for e in tree]}


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(ref, mesh, arch):
    """Every leaf's spec, bit for bit, for the full and the reduced config."""
    rules = MeshRules(cpu_mesh(*MESHES[mesh]))
    for cut in ("full", "reduced"):
        cfg = get_config(arch) if cut == "full" else get_config(arch).reduced()
        ps = build_model(cfg).param_specs()
        tree = {"params": ps, "moments": moment_specs(ps, rules), "batch": {}, "cache": {}}
        for shape in SHAPES:
            tree["batch"][shape] = batch_specs(cfg, shape)
            cache = cache_specs_for(cfg, shape)
            if cache is not None:
                tree["cache"][shape] = cache
        got = _flat(param_specs_pspec(tree, rules))
        want = ref["specs"][mesh][f"{arch}/{cut}"]
        assert sorted(got) == sorted(want), (cut, set(got) ^ set(want))
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        assert not diff, (cut, diff)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_fallbacks_match_reference(ref, mesh):
    m = cpu_mesh(*MESHES[mesh])
    got = [[_entry(e) for e in logical_to_spec(m, tuple(a), tuple(s))] for a, s in LOGICAL]
    assert got == ref["specs"][mesh]["logical"]
    if mesh == "1x16":  # 4 heads and the 256206 vocab do not split 16 ways
        assert got[0] == [None, None] and got[1] == [None, None]


@pytest.mark.parametrize("spec", ["2x1", "4x1", "8x1", "2x2x2"])
def test_zero1_splits_a_fifth_of_tinyllama_moments(spec):
    """ZeRO-1 splits a moment over the data axes only on a dimension whose
    logical axis is None: for tinyllama the attention's head dim (wq/wk/wv,
    wo), 0.83 GB of each 4.40 GB float32 moment at every data extent."""
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    shardings = moment_shardings(model, MeshRules(make_mesh_from_spec(spec, ["cpu"] * math.prod(
        int(x) for x in spec.split("x")))))
    total = split = 0
    for k, p in model.named_parameters():
        n = p.numel() * 4
        total += n
        if any(e == "data" or (isinstance(e, tuple) and "data" in e) for e in shardings[k].spec):
            split += n
            assert k.split(".")[-1] in ("wq", "wk", "wv", "wo") and ".attn." in k, k
    assert round(split / 1e9, 2) == 0.83 and round(total / 1e9, 2) == 4.40, (split, total)


def test_named_sharding_blocks():
    """A split stores each distinct block once: a replicated tensor one
    block, a 4-way split four; ``full`` reassembles; shardings map through
    ``models/convert.py`` with the stacked axis dropped."""
    mesh = cpu_mesh((4, 2), ("data", "model"))
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec, n in ((PartitionSpec(None, None), 1), (PartitionSpec("data", None), 4),
                    (PartitionSpec("data", "model"), 8), (PartitionSpec(None, "model"), 2)):
        s = NamedSharding(mesh, spec).split(t)
        assert isinstance(s, Sharded) and len(s.blocks) == n and s.nbytes == t.numel() * 4
        assert all(b.is_contiguous() and b.data_ptr() != t.data_ptr() for b in s.blocks.values())
        assert torch.equal(s.full(), t)
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, PartitionSpec(None, ("data", "model"))).split(t)
    cfg = get_config("tinyllama_1_1b").reduced()
    sh = moment_shardings(build_model(cfg), MeshRules(mesh))
    assert sh["layers.0.attn.wq"].spec == PartitionSpec(None, "model", "data")  # (d, H, hd): heads, ZeRO on hd


# ------------------------------------------------------------- train step
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_step_equals_single_device_step(arch):
    """Four steps on a (4, 2) mesh and on one device from the same state and
    batches: the same loss, grad norm, parameters, m and v, bit for bit."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    tc = TrainConfig(opt=OptConfig(**OPT))
    rules = MeshRules(cpu_mesh((4, 2), ("data", "model")))
    S = 16 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    batch = materialize_batch(cfg, "train_4k", S, 4)
    runs = []
    for r in (None, rules):
        state = make_train_state(model, torch.Generator().manual_seed(0), tc, r)
        step = make_train_step(model, tc, r)
        metrics = []
        for _ in range(4):
            state, m = step(state, batch)
            metrics.append(m)
        runs.append((state, metrics))
    (one, m1), (mesh, mm) = runs
    for a, b in zip(m1, mm):
        assert all(torch.equal(a[k], b[k]) for k in ("loss", "grad_norm", "lr"))
    split = [k for k, v in mesh["opt"]["m"].items() if len(v.blocks) > 1]
    assert split, "no moment was split"
    for k, p in one["params"].items():
        assert torch.equal(p, mesh["params"][k]), k
        for n in ("m", "v"):
            assert isinstance(mesh["opt"][n][k], Sharded)
            assert torch.equal(one["opt"][n][k], mesh["opt"][n][k].full()), (n, k)


def test_launch_train_mesh_matches_reference(ref, tmp_path, capsys):
    """The reference's ``--mesh 2x1`` run checkpoints at step 1 (its
    moments gathered whole); the port's ``--mesh 2x1`` run resumes from that
    checkpoint (converted), splitting the moments onto its mesh, and its
    steps 2-5 give the reference's losses. The port's own checkpoints hold
    whole moments that the reference's manager reads."""
    cfg = get_config("tinyllama_1_1b").reduced()
    tree, extra = CheckpointManager(ref["ckpt"]).restore(1)
    CheckpointManager(str(tmp_path)).save(1, train_state_from_reference(cfg, tree), extra)
    hist = launch_train.main(["--arch", "tinyllama_1_1b", "--reduced", "--steps", str(STEPS), "--batch", "2",
                              "--seq", "32", "--mesh", "2x1", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    assert capsys.readouterr().out.startswith(f"finished at step {STEPS}; loss ")
    assert [h["step"] for h in hist] == list(range(2, STEPS))
    for h in hist:
        want = ref["losses"][h["step"]]
        assert abs(h["loss"] - want) <= 1e-4 * max(1.0, abs(want)), (h, want)
    jtree, _ = JCheckpointManager(str(tmp_path)).restore()
    state, _ = CheckpointManager(str(tmp_path)).restore()
    assert int(state["opt"]["step"]) == STEPS
    for k, v in state["opt"]["v"].items():
        np.testing.assert_array_equal(jtree["opt"]["v"][k], v.numpy())


def test_launch_train_mesh_needs_devices_without_device_flag(tmp_path):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present: the mesh can be built")
    with pytest.raises(ValueError, match="Number of devices"):
        launch_train.main(["--arch", "tinyllama_1_1b", "--reduced", "--steps", "2", "--mesh", "2x1",
                           "--ckpt-dir", str(tmp_path)])


# ------------------------------------------------------------ checkpoints
def _trainer(d, rules, steps=8, ckpt_every=2):
    cfg = get_config("tinyllama_1_1b").reduced()
    toks = corpus.token_stream(20_000, cfg.vocab_size, seed=0)
    lc = LoopConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(d), log_every=1)
    return Trainer(build_model(cfg), TrainConfig(opt=OptConfig(**OPT)), lc,
                   lambda: corpus.batches(toks, 2, 32, seed=0), rules=rules, device=None if rules else "cpu")


def test_elastic_restore_across_meshes(tmp_path):
    """A run on (4, 1) checkpoints at step 3; copies of that checkpoint
    restore onto (2, 1) and onto no mesh and run to step 7: each ends with
    the uninterrupted (4, 1) run's state, bit for bit."""
    r41 = MeshRules(cpu_mesh((4, 1), ("data", "model")))
    whole = _trainer(tmp_path / "whole", r41)
    assert whole.train() == 8
    final, _ = whole.ckpt.restore(7)
    for name, rules in (("r21", MeshRules(cpu_mesh((2, 1), ("data", "model")))), ("none", None)):
        tr = _trainer(tmp_path / name, rules)
        step3, extra = whole.ckpt.restore(3)
        tr.ckpt.save(3, step3, extra)
        sh = moment_shardings(tr.model, rules)
        restored, _ = tr.ckpt.restore(3, shardings={"opt": {"m": sh, "v": sh}} if sh else None)
        sample = restored["opt"]["m"]["layers.0.attn.wq"]
        if rules is None:
            assert isinstance(sample, torch.Tensor)
        else:
            assert isinstance(sample, Sharded) and len(sample.blocks) == 2
        assert tr.train() == 8
        assert [h["step"] for h in tr.history] == [4, 5, 6, 7]
        got, _ = tr.ckpt.restore(7)
        assert all(torch.equal(got["params"][k], final["params"][k]) for k in final["params"]), name
        for n in ("m", "v"):
            assert all(torch.equal(got["opt"][n][k], final["opt"][n][k]) for k in final["opt"][n]), (name, n)
