"""Port front door vs reference: ``repro_torch.mining.mine`` against
``repro.mining.mine`` for every ported miner, the backend registry, the
one-shot CLI, and import isolation (no JAX, nothing of ``repro``)."""
import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.mining as jmining
import repro_torch.mining as tmining
from repro.data.synth import load, random_db
from repro_torch.mining import tune

ROOT = Path(__file__).resolve().parents[1]


def _dbs():
    from repro.core.encoding import pad_transactions

    from conftest import PAPER_TX

    return [
        ("paper", pad_transactions(PAPER_TX), 7, {"min_count": 3}),
        ("random", random_db(np.random.default_rng(4), 90, 12, 6), 12, {"min_count": 3}),
        ("chess", *load("chess", scale=0.05), {"min_sup": 0.6}),
    ]


# the brute-force oracle only on the small databases
CASES = [(a, db) for a in ("hprepost", "prepost", "prepost+", "fpgrowth", "apriori", "bruteforce")
         for db in _dbs()
         if a != "bruteforce" or len(db[1]) <= 100]


@pytest.mark.parametrize("algorithm,db", CASES, ids=[f"{a}-{db[0]}" for a, db in CASES])
@pytest.mark.parametrize("early_stop", [True, False])
def test_mine_front_door_parity(algorithm, db, early_stop):
    _, rows, n_items, thr = db
    want = jmining.mine(rows, n_items, jmining.MineSpec(
        algorithm=algorithm, backend="jnp", early_stop=early_stop, **thr))
    got = tmining.mine(rows, n_items, tmining.MineSpec(
        algorithm=algorithm, early_stop=early_stop, **thr), device="cpu")
    assert got.itemsets == want.itemsets
    for f in ("algorithm", "total_count", "n_explicit", "min_count", "n_rows", "peak_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    if want.flist_items is None:
        assert got.flist_items is None
    else:
        np.testing.assert_array_equal(got.flist_items, want.flist_items)
    if algorithm == "hprepost":
        for k in ("planned_candidates", "host_pruned_parent", "host_pruned_subset"):
            assert got.stage_times_s[k] == want.stage_times_s[k], k


@pytest.mark.parametrize("patterns", ["closed", "maximal", "top_rank_k"])
def test_pattern_post_passes(paper_db, patterns):
    rows, n_items = paper_db
    want = jmining.mine(rows, n_items, jmining.MineSpec(min_count=2, patterns=patterns, backend="jnp"))
    got = tmining.mine(rows, n_items, tmining.MineSpec(min_count=2, patterns=patterns), device="cpu")
    assert got.itemsets == want.itemsets


@pytest.mark.parametrize("name", ["pallas", "pallas-tpu", "pallas-gpu", "pallas-interpret", "jnp", "triton"])
def test_reference_backend_names_rejected(name):
    with pytest.raises(ValueError, match="registered backends: auto, cuda, torch"):
        tmining.MineSpec(min_count=1, backend=name).resolve(10)
    with pytest.raises(ValueError, match="registered backends"):
        tune.resolve_backend(name, "cpu")


def test_backend_registry_keys_on_device_type():
    assert tune.registered_backends() == ["auto", "cuda", "torch"]
    assert tune.resolve_backend("auto", "cpu") == "torch"
    assert tune.resolve_backend("auto", "cuda") == "cuda"
    assert tune.resolve_backend("torch", "cuda") == "torch"
    assert tune.resolve_backend("cuda", "cuda") == "cuda"
    with pytest.raises(ValueError, match="not available"):
        tune.resolve_backend("cuda", "cpu")
    plan = tune.static_plan("auto", 64, True, "cpu")
    assert (plan.backend, plan.la_block, plan.early_stop, plan.source) == ("torch", 64, True, "config")
    assert [tune._bucket(n, 8, 512) for n in (1, 9, 300, 5000)] == [8, 16, 512, 512]


def test_cli_one_shot_matches_reference(capsys):
    from repro.launch.mine import main as jmain
    from repro_torch.launch.mine import main as tmain

    args = ["--dataset", "chess", "--scale", "0.05", "--min-sup", "0.6", "--top", "3"]
    got = tmain(args + ["--device", "cpu"])
    want = jmain(args + ["--backend", "jnp"])
    assert got.itemsets == want.itemsets
    assert "hprepost:" in capsys.readouterr().out
    got = tmain(args + ["--device", "cpu", "--no-early-stop", "--algo", "prepost"])
    assert got.itemsets == want.itemsets


def test_cli_sweep_matches_reference(capsys):
    import re

    from repro.launch.mine import main as jmain
    from repro_torch.launch.mine import main as tmain

    args = ["--dataset", "mushroom", "--scale", "0.1", "--sweep", "0.4,0.3,0.2"]
    got = tmain(args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    want = jmain(args + ["--backend", "jnp"])
    jout = capsys.readouterr().out
    assert [r.itemsets for r in got] == [r.itemsets for r in want]
    # the same report line for line, [shared prep] markers included, but the clocks
    untimed = [re.sub(r" in [0-9.]+s ", " ", line) for line in (tout, jout)]
    assert untimed[0] == untimed[1] and tout.count("[shared prep]") == 2


def test_cli_tune_cold_then_warm(tmp_path):
    from repro_torch.launch.mine import main as tmain

    args = ["--dataset", "chess", "--scale", "0.05", "--min-sup", "0.6", "--device", "cpu",
            "--tune", "--snapshot-dir", str(tmp_path)]
    cold = tmain(args + ["--expect-plans", "cold"])
    warm = tmain(args + ["--expect-plans", "warm"])  # raises SystemExit unless zero trials
    assert warm.itemsets == cold.itemsets
    assert warm.service_stats["prep_source"] == "snapshot"
    with pytest.raises(SystemExit):
        tmain(args + ["--expect-plans", "cold"])  # warm plans are no cold tune


def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    return sorted(
        ".".join(("repro_torch", *p.relative_to(pkg).with_suffix("").parts)).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )


def test_port_imports_neither_jax_nor_reference():
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print('LOADED', len(sys.modules)); print('BAD', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
    assert len(mods) >= 25
    assert {"repro_torch.sharding", "repro_torch.sharding.rules", "repro_torch.training.pipeline",
            "repro_torch.launch.cost", "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.dryrun_fim"} <= set(mods)


def test_chip_smoke_imports_and_cpu_exit(tmp_path):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    if torch.cuda.is_available():
        return  # the full smoke runs on the card, not inside the tests
    # without a CUDA device, and alone in a directory, it exits non-zero and
    # prints no result
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0 and out.stdout == ""


def test_chip_compare_imports_and_cpu_exit():
    tree = ast.parse((ROOT / "chip_compare.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(ROOT / "chip_compare.py")], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("stop_mult", [None, 1, 3])
def test_chip_smoke_wave_bytes_counts_valid_prefixes(stop_mult):
    """The B1/B2 bound bytes that chip_smoke prints (``ops.wave_cost``, at
    la_block 8 here) equal a count made slot by slot: the union over
    candidates of A pre/post up to the stop slot (B2: plus A counts up to the
    valid length), the Y counts of the codes whose ancestor slot lies before
    it and their pre/post where nonzero, each row once; its operations are
    the nonzero Y codes merged, (log2 W + 2) each."""
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
    from repro_torch.kernels.nlist_intersect.ops import wave_cost
    from repro_torch.data import synth
    from repro_torch.kernels.nlist_intersect import ref as nl_ref

    rows, n_items = synth.load("mushroom", scale=0.02)
    mc = int(np.ceil(0.15 * len(rows)))
    miner = HPrepostMiner("cpu", HPrepostConfig())
    prep = miner.prepare(rows, n_items, mc)
    qs, ps = np.nonzero(prep.C >= mc)
    ranks = np.stack([qs, ps], 1).astype(np.int32)
    idx = torch.from_numpy(miner._pack_wave(ranks, ps.astype(np.int64), qs.astype(np.int32))[0])
    planes = prep.packed[0].permute(2, 0, 1).contiguous()
    state, n_live = planes[2], len(ranks)
    live = idx[:, :n_live]
    stop = None
    if stop_mult:
        exact = nl_ref.nlist_wave_ref(planes, state, idx, n_live)[0][:n_live]
        stop = nl_ref.first_dead_slot(exact, planes[0][live[2]], planes[2][live[2]], stop_mult * mc, 8)
    got, got_ops = wave_cost(planes, state, idx, n_live, early_stop=stop is not None,
                             min_count=(stop_mult or 0) * mc, la_block=8)

    B, W = idx.shape[1], planes.shape[2]
    pad = torch.iinfo(torch.int32).max
    pre_post, counts, want_nz = set(), set(), 0  # (row, slot); counts: rows of planes[2] = state
    for b in range(n_live):
        qa, qy, qc = (int(r) for r in (live[2, b], live[1, b], live[0, b]))
        ap, yp, yc = planes[0][qa], planes[0][qy], state[qc]
        na, ny = int((ap != pad).sum()), int((yp != pad).sum())
        p = na if stop is None else min(int(stop[b]), na)
        anc = torch.searchsorted(ap[:na].contiguous(), yp[:ny].contiguous()) - 1
        my = int((anc < p).sum())
        assert bool((anc[:my] < p).all())  # the Y codes needed are a prefix
        pre_post |= {(qa, i) for i in range(p)}
        pre_post |= {(qy, j) for j in range(my) if int(yc[j])}
        counts |= {(qc, j) for j in range(my)}
        if stop is not None:
            counts |= {(qa, i) for i in range(na)}
        want_nz += int((yc[:my] != 0).sum())
    want = 8 * len(pre_post) + 4 * len(counts) + B * W * 4 + B * 4 + 3 * n_live * 8
    assert (got, got_ops) == (want, want_nz * (math.ceil(math.log2(W)) + 2))
    if stop_mult == 3:
        assert int((stop < (planes[0][live[2]] != pad).sum(1)).sum()) > 0  # some die early
