"""The train step, the Trainer and the launcher, port against the JAX package.

Reduced tinyllama, float32. The port's steps are held to the reference's
jitted ``make_train_step`` from the same state (carried across by
``train_state_from_reference``) on the same batches: losses within 1e-4 ×
max(1, |loss|), ``lr`` within 4 float32 ulps and ``grad_norm`` within 1e-4
of itself. Parameters are not compared elementwise after a step: AdamW's
first steps move every element by about ±lr whatever its gradient's size, so
a gradient that float32 rounding flips in sign moves its parameter 2·lr the
other way. Checkpoints cross between the two packages' Trainers in both
directions, the next steps' losses held the same way. The port's own
restarts are bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs.base import get_config as jget_config
from repro.data import corpus as jcorpus
from repro.models.registry import build_model as jbuild
from repro.training.optim import OptConfig as JOptConfig
from repro.training.step import TrainConfig as JTrainConfig
from repro.training.step import make_train_state as jmake_train_state
from repro.training.step import make_train_step as jmake_train_step
from repro.training.trainer import LoopConfig as JLoopConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data import corpus
from repro_torch.fault.failures import FailureInjector, SimulatedFailure
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import train_state_from_reference, train_state_to_reference
from repro_torch.models.registry import build_model
from repro_torch.training.optim import OptConfig
from repro_torch.training.step import TrainConfig, make_train_state, make_train_step
from repro_torch.training.trainer import LoopConfig, Trainer

ARCH = "tinyllama_1_1b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)


def _batches(vocab, seq=32, batch=2, seed=0):
    toks = corpus.token_stream(20_000, vocab, seed=seed)
    return lambda: corpus.batches(toks, batch, seq, seed=seed)


def _close_loss(got, want, what=""):
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), f"{what}: {got} vs {want}"


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_corpus_is_the_reference_corpus():
    toks = corpus.token_stream(5_000, 256, seed=3)
    np.testing.assert_array_equal(toks, jcorpus.token_stream(5_000, 256, seed=3))
    a, b = corpus.batches(toks, 2, 16, seed=1), jcorpus.batches(toks, 2, 16, seed=1)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])


def test_train_steps_match_reference_jitted_step():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jtc = JTrainConfig(opt=JOptConfig(**OPT))
    jstate = jmake_train_state(jmodel, jax.random.PRNGKey(0), jtc)
    state = train_state_from_reference(cfg, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jmake_train_step(jmodel, jtc))
    step = make_train_step(build_model(cfg), TrainConfig(opt=OptConfig(**OPT)))
    gen = _batches(cfg.vocab_size)()
    for i in range(4):
        batch = next(gen)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tensors(batch))
        _close_loss(float(m["loss"]), float(jm["loss"]), f"step {i} loss")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=4 * np.finfo(np.float32).eps)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 4


@pytest.mark.parametrize("compression", [None, "int8", "topk"])
def test_make_train_state_layout(compression):
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    state = make_train_state(model, torch.Generator().manual_seed(42), TrainConfig(compression=compression))
    keys = sorted(model.state_dict())
    assert sorted(state["params"]) == sorted(state["opt"]["m"]) == sorted(state["opt"]["v"]) == keys
    assert ("residuals" in state) == (compression is not None)
    assert state["rng"].dtype == torch.uint8
    # every leaf its own storage: the in-place update writes one leaf only
    ptrs = {t.untyped_storage().data_ptr() for t in state["params"].values()}
    assert len(ptrs) == len(keys)
    again = make_train_state(model, torch.Generator().manual_seed(42), TrainConfig())
    assert all(torch.equal(state["params"][k], again["params"][k]) for k in keys)


def _trainer(tmp, steps=24, ckpt_every=8, injector=None, compression=None, max_restarts=5):
    cfg = get_config(ARCH).reduced()
    tc = TrainConfig(opt=OptConfig(**OPT), compression=compression)
    lc = LoopConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmp), log_every=1,
                    max_restarts=max_restarts)
    return Trainer(build_model(cfg), tc, lc, _batches(cfg.vocab_size), failure_injector=injector, device="cpu")


@pytest.mark.parametrize("compression", [None, "int8"])
def test_checkpoint_restart_bitexact(tmp_path, compression):
    """Failure mid-run + restart from checkpoint == uninterrupted run (the
    reference's test); under int8 compression the generator's state rides
    in the checkpoint, so the noise replays too."""
    def run(d, injector):
        tr = _trainer(tmp_path / d, injector=injector, compression=compression)
        assert tr.train() == 24
        state, extra = tr.ckpt.restore()
        return tr, state, extra

    tr_fail, s_fail, _ = run("a", FailureInjector(fail_at_steps=(13,)))
    tr_ok, s_ok, extra = run("b", None)
    assert [h["step"] for h in tr_fail.history] == list(range(13)) + list(range(8, 24))
    for k in s_ok["params"]:
        assert torch.equal(s_fail["params"][k], s_ok["params"][k]), k
        assert torch.equal(s_fail["opt"]["v"][k], s_ok["opt"]["v"][k]), k
    assert torch.equal(s_fail["rng"], s_ok["rng"])
    assert extra["loss"] == tr_ok.history[-1]["loss"]
    assert tr_ok.ckpt.list_steps() == [7, 15, 23]


def test_failure_exhausts_retries(tmp_path):
    tr = _trainer(tmp_path, steps=10, ckpt_every=100, injector=FailureInjector(fail_prob=1.0), max_restarts=2)
    with pytest.raises(SimulatedFailure):
        tr.train()


def test_checkpoint_manager_round_trip_and_retention(tmp_path):
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8), "n": {"step": torch.tensor(5, dtype=torch.int32),
             "rng": torch.arange(16, dtype=torch.uint8), "h": torch.full((3,), 1.5, dtype=torch.bfloat16)}}
    cm = CheckpointManager(str(tmp_path / "a"))
    cm.save(0, state, extra={"note": "t"})
    restored, extra = cm.restore()
    assert extra == {"note": "t"}
    assert torch.equal(restored["w"], state["w"]) and torch.equal(restored["n"]["rng"], state["n"]["rng"])
    assert restored["n"]["step"].dtype == torch.int32 and int(restored["n"]["step"]) == 5
    assert restored["n"]["h"].dtype == torch.float32 and torch.equal(restored["n"]["h"], state["n"]["h"].float())
    # an async save holds a copy: the step loop writes its tensors in place
    w0 = state["w"].clone()
    cm.save(1, state, block=False)
    state["w"].add_(1.0)
    assert cm.latest_step() == 1  # waits for the save in flight
    assert torch.equal(cm.restore(1)[0]["w"], w0)
    # the reference's manager reads the port's directory, and the other way
    jstate, _ = JCheckpointManager(str(tmp_path / "a")).restore(0)
    np.testing.assert_array_equal(jstate["w"], w0.numpy())
    JCheckpointManager(str(tmp_path / "j")).save(4, {"w": np.ones((2, 3), np.float32)}, extra={"loss": 1.0})
    back, extra = CheckpointManager(str(tmp_path / "j")).restore(4, device="cpu")
    assert torch.equal(back["w"], torch.ones(2, 3)) and extra == {"loss": 1.0}
    # keep=2 prunes the oldest; keep=0 retains every step
    for keep, want in ((2, [3, 4]), (0, [0, 1, 2, 3, 4])):
        cm = CheckpointManager(str(tmp_path / f"k{keep}"), keep=keep)
        for s in range(5):
            cm.save(s, state, block=s % 2 == 0)
        cm.wait()
        assert cm.list_steps() == want and cm.latest_step() == want[-1]
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None, None)


def _jtrainer(tmp, steps):
    cfg = jget_config(ARCH).reduced()
    tc = JTrainConfig(opt=JOptConfig(**OPT))
    lc = JLoopConfig(total_steps=steps, ckpt_every=4, ckpt_dir=str(tmp), log_every=1)
    return JTrainer(jbuild(cfg), tc, lc, _batches(cfg.vocab_size))


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The reference's Trainer runs 8 steps, checkpointing at steps 3 and
    7; the port resumes from its step-3 checkpoint (converted) and its steps
    4-7 give the reference's losses."""
    cfg = get_config(ARCH).reduced()
    jtr = _jtrainer(tmp_path / "ref", 8)
    assert jtr.train() == 8
    tree, extra = CheckpointManager(str(tmp_path / "ref")).restore(3)
    CheckpointManager(str(tmp_path / "port")).save(3, train_state_from_reference(cfg, tree), extra)
    tr = _trainer(tmp_path / "port", steps=8, ckpt_every=4)
    assert tr.train() == 8
    assert [h["step"] for h in tr.history] == [4, 5, 6, 7]
    for h, jh in zip(tr.history, jtr.history[4:]):
        _close_loss(h["loss"], jh["loss"], f"step {h['step']}")


def test_port_checkpoint_resumes_in_reference(tmp_path):
    cfg = get_config(ARCH).reduced()
    tr = _trainer(tmp_path / "port", steps=8, ckpt_every=4)
    assert tr.train() == 8
    state, extra = tr.ckpt.restore(3)
    tree = train_state_to_reference(cfg, state)
    assert tree["params"]["layers"]["attn"]["wq"].shape[0] == cfg.n_layers  # stacked again
    JCheckpointManager(str(tmp_path / "ref")).save(3, tree, extra)
    jtr = _jtrainer(tmp_path / "ref", 8)
    assert jtr.train() == 8
    assert [h["step"] for h in jtr.history] == [4, 5, 6, 7]
    for jh, h in zip(jtr.history, tr.history[4:]):
        _close_loss(jh["loss"], h["loss"], f"step {h['step']}")


def test_train_state_converters_round_trip():
    cfg = get_config("granite_moe").reduced()
    state = make_train_state(build_model(cfg), torch.Generator().manual_seed(1), TrainConfig(compression="int8"))
    tree = train_state_to_reference(cfg, state)
    assert tree["rng"].dtype == np.uint32 and not tree["rng"].any()  # PRNGKey(0)
    back = train_state_from_reference(cfg, tree)
    for part in ("params", "residuals"):
        for k, t in state[part].items():
            assert torch.equal(back[part][k], t), (part, k)
    for k, t in state["opt"]["m"].items():
        assert torch.equal(back["opt"]["m"][k], t)
    assert torch.equal(back["opt"]["step"], state["opt"]["step"])


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "internvl2_26b", "seamless_m4t_v2"])
def test_launch_train_cpu(tmp_path, capsys, arch):
    """The entry point on the CPU with a failure injected: it restarts from
    its checkpoint and finishes (the VLM with zero patches, the encdec with
    zero frames, as the reference's launcher)."""
    hist = launch_train.main(["--arch", arch, "--reduced", "--steps", "6", "--ckpt-every", "3", "--batch", "2",
                              "--seq", "32", "--inject-failure-at", "4", "--ckpt-dir", str(tmp_path),
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("finished at step 6; loss ")
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000005"]


def test_launch_train_needs_cuda_or_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--ckpt-dir", str(tmp_path)])
