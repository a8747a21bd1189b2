"""The static-cache serving path, port against the JAX package.

``repro_torch.serving.Engine.generate`` must give the reference Engine's
greedy tokens, token for token, on one arch of each family (reduced
configs, float32, the reference's weights carried across by
``repro_torch.models.convert``), for ``launch.serve``'s request set: four
prompts of 4-23 tokens from ``numpy.random.default_rng(0)``, left-padded
into one batch of 4 with a 128-slot cache, 16 new tokens each. Greedy
decoding compares argmaxes, so the tokens are held exactly; the logits
behind them agree to float32 rounding (``test_torch_lm_archs.py``). The
reference runs as in its own tests: ``jax.jit`` on the CPU.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.common import init_params as jinit
from repro.models.registry import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.base import get_config
from repro_torch.models.convert import params_from_reference
from repro_torch.serving.engine import Engine, Request


def _prompts(vocab, n=4):
    """``launch.serve``'s request set (both packages draw it the same way)."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=rng.integers(4, 24)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "granite_moe", "xlstm_125m", "zamba2_2_7b",
                                  "seamless_m4t_v2"])
def test_generate_matches_reference_engine(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = jinit(jbuild(jcfg).param_specs(), jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)
    want = JEngine(jcfg, params, batch_size=4, max_seq=128).generate(
        [JRequest(p, max_new=16) for p in prompts])
    eng = Engine(cfg, params_from_reference(cfg, jax.tree.map(np.asarray, params)),
                 batch_size=4, max_seq=128, device="cpu")
    got = eng.generate([Request(p, max_new=16) for p in prompts])
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 16 and all(0 <= t < cfg.padded_vocab for t in r.out) for r in got)
    # a second wave through the same engine: a fresh cache, the same tokens
    again = eng.generate([Request(p, max_new=16) for p in prompts])
    assert [r.out for r in again] == [r.out for r in got]


def test_generate_stops_at_cache_end_and_max_new():
    """``pos >= max_seq - 1`` ends the wave (the reference's stop), and each
    request keeps at most its own ``max_new`` tokens."""
    jcfg, cfg = jget_config("tinyllama_1_1b").reduced(), get_config("tinyllama_1_1b").reduced()
    params = jinit(jbuild(jcfg).param_specs(), jax.random.PRNGKey(0))
    prompts = [np.arange(1, 20, dtype=np.int32), np.arange(5, 9, dtype=np.int32)]
    want = JEngine(jcfg, params, batch_size=3, max_seq=24).generate(
        [JRequest(prompts[0], max_new=9), JRequest(prompts[1], max_new=3)])
    got = Engine(cfg, params_from_reference(cfg, jax.tree.map(np.asarray, params)),
                 batch_size=3, max_seq=24, device="cpu").generate(
        [Request(prompts[0], max_new=9), Request(prompts[1], max_new=3)])
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [5, 3]  # positions 19..23: 5 tokens, then the stop


def test_serve_cli_on_cpu(capsys):
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain

    done = tmain(["--arch", "tinyllama_1_1b", "--reduced", "--device", "cpu", "--max-new", "5"])
    out = capsys.readouterr().out.splitlines()
    assert len(done) == 4 and all(len(r.out) == 5 for r in done)
    assert all(re.fullmatch(r"req\d: prompt\[\d+\] -> \[[\d, ]+\]", line) for line in out)
    want = jmain(["--arch", "tinyllama_1_1b", "--reduced", "--max-new", "5"])
    capsys.readouterr()
    # the same prompts; the weights (and so the tokens) are the port's own
    assert [r.prompt.tolist() for r in done] == [r.prompt.tolist() for r in want]


def test_engine_without_device_needs_cuda(monkeypatch):
    """No hidden fallback: without ``device`` the engine runs on CUDA, and
    on a host without it building one raises."""
    cfg = get_config("tinyllama_1_1b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, {}, batch_size=1, max_seq=8)
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "tinyllama_1_1b", "--reduced"])
