"""The examples' PyTorch twins (``examples/*_torch.py``), each run once on
the CPU in a subprocess: each makes its reference twin's assertions and
imports only ``repro_torch``."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), "--device", "cpu",
                          *args], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("script,args,says", [
    ("quickstart_torch.py", (), "cache after ad-hoc resubmit: 1 hit(s)"),
    ("mine_corpus_torch.py", (), "of size 4"),
    ("serve_lm_torch.py", (), "OK: 6 requests served"),
    # the fewest steps (failure injected at half) whose last loss is below the first
    ("train_lm_torch.py", ("--steps", "2"), "OK: loss improved"),
])
def test_example_twin_runs(tmp_path, script, args, says):
    if script == "train_lm_torch.py":
        args = args + ("--ckpt-dir", str(tmp_path))
    assert says in _run(script, *args)


@pytest.mark.parametrize("script", ["quickstart_torch.py", "mine_corpus_torch.py",
                                    "serve_lm_torch.py", "train_lm_torch.py"])
def test_example_twin_imports_only_the_port(script):
    src = open(os.path.join(ROOT, "examples", script)).read()
    assert "import jax" not in src and "from repro." not in src and "import repro." not in src
    assert "repro_torch" in src and '"--device", default="cuda"' in src
