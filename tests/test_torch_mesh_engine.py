"""The layers above the miner on a D×M mesh: the front door, the
``MiningEngine`` (sweeps, cache, snapshots across mesh shapes), the
``MiningService``, streams and the CLI's ``--mesh``, held to the reference
on the same mesh shapes (itemsets, every ``MineResult`` field but the
clocks, engine stats and cache counters, stream segment payloads) and to
the host PrePost miner, with no tolerance.

The reference runs once per module in a subprocess with eight host
devices (its device count is fixed when JAX starts) and writes what it
answered to an ``.npz``; the port runs in process with every position on
``"cpu"``.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.prepost import mine_prepost
from repro_torch.data.synth import load
from repro_torch.launch import mine as cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.mining import MineSpec, MiningEngine, MiningService, get_miner
from repro_torch.mining.stream import StreamSpec

SRC = str(Path(__file__).resolve().parents[1] / "src")
SPEC = dict(algorithm="hprepost", candidate_unit=8)
FRACS = [0.4, 0.3, 0.2]
CACHE_KEYS = ("hits", "misses", "evictions", "snapshot_hits", "snapshot_misses",
              "snapshot_spill_failures", "entries", "bytes_in_use")
PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset")
PREP_KEYS = ("job1_flist", "job2_ppc_pack", "f2_scan")


def res_meta(r):
    """A MineResult as comparable data, clocks left out."""
    st = r.stage_times_s
    return dict(
        itemsets=sorted([list(k), v] for k, v in r.itemsets.items()),
        fields=[r.algorithm, r.total_count, r.n_explicit, r.min_count, r.n_rows,
                int(r.peak_bytes), bool(r.prep_shared)],
        service_stats={k: v for k, v in sorted(r.service_stats.items())},
        flist=None if r.flist_items is None else [int(x) for x in r.flist_items],
        stage_keys=sorted(st),
        planning={k: st[k] for k in PLANNING if k in st},
        prep_paid={k: st[k] != 0.0 for k in PREP_KEYS if k in st},
    )


def engine_meta(e):
    info = e.cache_info()
    return dict(stats=dict(e.stats), cache={k: info[k] for k in CACHE_KEYS if k in info})


# the reference side runs the same two functions
_REF = textwrap.dedent(
    """
    import json, os, sys, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.compat import make_mesh
    from repro.data.synth import load
    from repro.mining import MineSpec, MiningEngine, get_miner
    from repro.mining.stream import StreamSpec

    SPEC, FRACS, CACHE_KEYS, PLANNING, PREP_KEYS = json.loads(sys.argv[2])
    """
) + inspect.getsource(res_meta) + inspect.getsource(engine_meta) + textwrap.dedent(
    """
    DM = ("data", "model")
    rows, n_items = load("mushroom", scale=0.05)
    spec = MineSpec(**SPEC)
    out = {}

    # the front door on (4, 2), mode B and mode A
    for b in (True, False):
        fe = get_miner("hprepost", mesh=make_mesh((4, 2), DM))
        r = fe.mine(rows, n_items, spec.with_(min_sup=0.3, partition_candidates=b))
        out[f"frontdoor-{b}"] = res_meta(r)

    # a planned sweep on (2, 2), then a repeat served from the cache
    eng = MiningEngine(make_mesh((2, 2), DM))
    out["sweep"] = [res_meta(r) for r in eng.sweep(rows, n_items, spec, FRACS)]
    out["sweep-repeat"] = res_meta(eng.submit(rows, n_items, spec.with_(min_sup=0.3)))
    out["sweep-engine"] = engine_meta(eng)

    # snapshots: written on (2, 1), warm on (2, 2) (the model axis is free),
    # rebuilt on (1, 1) (another shard count)
    with tempfile.TemporaryDirectory() as snap:
        for label, shape in (("snap-write", (2, 1)), ("snap-warm", (2, 2)),
                             ("snap-rebuild", (1, 1))):
            e = MiningEngine(make_mesh(shape, DM), snapshot_dir=snap)
            out[label] = res_meta(e.submit(rows, n_items, spec.with_(min_sup=0.3)))
            out[label + "-engine"] = engine_meta(e)

    # a stream of 4 batches (padded to 32 rows) on (2, 2)
    eng = MiningEngine(make_mesh((2, 2), DM))
    for b in np.array_split(rows, 4):
        eng.append(b, n_items, spec=spec, stream_spec=StreamSpec(row_pad=32))
    out["stream"] = [res_meta(eng.submit_stream(spec.with_(min_sup=f))) for f in FRACS[1:]]
    arrays = {}
    for i, s in enumerate(eng.stream().db.segments):
        for k, v in s.prepared.to_host().items():
            if isinstance(v, np.ndarray):
                arrays[f"seg{i}/{k}"] = v
    np.savez(sys.argv[1], meta=np.array(json.dumps(out)), **arrays)
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """What the reference answered: ``(meta, segment payload arrays)``."""
    path = tmp_path_factory.mktemp("mesh_engine_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    args = json.dumps([SPEC, FRACS, CACHE_KEYS, PLANNING, PREP_KEYS])
    out = subprocess.run([sys.executable, "-c", _REF, str(path), args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return json.loads(str(z["meta"])), {k: z[k] for k in z.files if k != "meta"}


@pytest.fixture(scope="module")
def db():
    return load("mushroom", scale=0.05)


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def host(db, r):
    return mine_prepost(db[0], db[1], r.min_count).itemsets


@pytest.mark.parametrize("mode_b", [True, False])
def test_front_door(ref, db, mode_b):
    fe = get_miner("hprepost", mesh=cpu_mesh((4, 2)))
    assert fe.mesh.shape == {"data": 4, "model": 2} and fe.model_axis == "model"
    r = fe.mine(*db, MineSpec(**SPEC).with_(min_sup=0.3, partition_candidates=mode_b))
    assert res_meta(r) == ref[0][f"frontdoor-{mode_b}"]
    assert r.itemsets == host(db, r)
    miner = fe.miner_for(MineSpec(**SPEC, partition_candidates=mode_b))
    assert (miner.D, miner.M, miner._Mb) == (4, 2, 2 if mode_b else 1)
    # host miners take the mesh keywords and ignore them
    apr = get_miner("apriori", mesh=cpu_mesh((4, 2)), data_axis="data", model_axis=None)
    assert apr.mine(*db, MineSpec(algorithm="apriori", min_sup=0.3)).itemsets == r.itemsets


def test_engine_sweep_and_cache(ref, db):
    eng = MiningEngine(mesh=cpu_mesh((2, 2)))
    got = eng.sweep(*db, MineSpec(**SPEC), FRACS)
    assert [res_meta(r) for r in got] == ref[0]["sweep"]
    assert res_meta(eng.submit(*db, MineSpec(**SPEC, min_sup=0.3))) == ref[0]["sweep-repeat"]
    assert engine_meta(eng) == ref[0]["sweep-engine"]
    assert all(r.itemsets == host(db, r) for r in got)
    assert eng.devices() == [eng.device] and eng.device.type == "cpu"
    with pytest.raises(ValueError, match="not both"):
        MiningEngine("cpu", mesh=cpu_mesh((2, 2)))


def test_snapshots_across_mesh_shapes(ref, db, tmp_path):
    """A (2, 1) snapshot warm-starts a (2, 2) engine with zero prepares; a
    (1, 1) engine cannot use it (another shard count) and rebuilds; every
    answer is the same."""
    spec = MineSpec(**SPEC, min_sup=0.3)
    answers = []
    for label, shape in (("snap-write", (2, 1)), ("snap-warm", (2, 2)), ("snap-rebuild", (1, 1))):
        e = MiningEngine(mesh=cpu_mesh(shape), snapshot_dir=str(tmp_path))
        r = e.submit(*db, spec)
        assert res_meta(r) == ref[0][label], label
        assert engine_meta(e) == ref[0][label + "-engine"], label
        answers.append(r)
    assert [r.service_stats["prep_source"] for r in answers] == ["built", "snapshot", "built"]
    assert all(r.itemsets == host(db, r) for r in answers)


def test_service_batch_on_a_mesh(ref, db):
    """One (2, 2) ``MiningService`` batch: the sweep as one shared-prep
    group and a host apriori beside it, each answer the reference engine's
    and the host miner's."""
    with MiningService(mesh=cpu_mesh((2, 2)), batch_window_s=0.05) as svc:
        assert svc.engine.mesh.shape == {"data": 2, "model": 2}
        assert svc.scheduler.prep_streams == []  # the CPU has no streams
        futs = svc.sweep(*db, MineSpec(**SPEC), FRACS)
        futs.append(svc.submit(*db, MineSpec(algorithm="apriori", min_sup=0.2)))
        got = [f.result(timeout=120) for f in futs]
    for g, w in zip(got, ref[0]["sweep"]):
        assert res_meta(g)["itemsets"] == w["itemsets"]
        assert res_meta(g)["fields"][5] == w["fields"][5]  # peak_bytes
    assert got[-1].itemsets == got[2].itemsets
    assert all(r.itemsets == host(db, r) for r in got)
    with pytest.raises(ValueError, match="not both"):
        MiningService(device="cpu", mesh=cpu_mesh((2, 2)))


def test_stream_on_a_mesh(ref, db):
    """Four batches streamed into a (2, 2) engine: every segment's payload
    and every query equal the reference's stream on the same mesh, the host
    miner's and a one-shot mine's."""
    meta, arrays = ref
    eng = MiningEngine(mesh=cpu_mesh((2, 2)))
    for b in np.array_split(db[0], 4):
        eng.append(b, db[1], spec=MineSpec(**SPEC), stream_spec=StreamSpec(row_pad=32))
    got = [eng.submit_stream(MineSpec(**SPEC, min_sup=f)) for f in FRACS[1:]]
    assert [res_meta(r) for r in got] == meta["stream"]
    segs = eng.stream().db.segments
    assert len(segs) == 4 and all(len(s.shard_planes) == 2 for s in segs)
    for i, s in enumerate(segs):
        payload = s.prepared.to_host()
        for k, v in payload.items():
            if isinstance(v, np.ndarray):
                w = arrays[f"seg{i}/{k}"]
                assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), (i, k)
    assert all(r.itemsets == host(db, r) for r in got)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_stream_compaction_on_a_mesh(db, shape):
    """A mesh stream that compacts agrees with the port's 1×1 stream and the
    host miner: compaction merges every shard's rows and re-prepares them."""
    ss = StreamSpec(row_pad=32, max_segments=3, compact_fanin=2)
    answers = []
    for eng in (MiningEngine(mesh=cpu_mesh(shape)), MiningEngine(device="cpu")):
        for b in np.array_split(db[0], 4):
            eng.append(b, db[1], spec=MineSpec(**SPEC), stream_spec=ss)
        assert eng.stream_stats()["default"]["compactions"] >= 1
        answers.append(eng.submit_stream(MineSpec(**SPEC, min_sup=0.3)))
    assert answers[0].itemsets == answers[1].itemsets == host(db, answers[0])


def test_cli_mesh(db, capsys):
    """``--device cpu --mesh 2x2`` answers as ``--mesh 1x1`` and as no
    ``--mesh`` at all; the sweep, serve and append paths take the mesh too."""
    base = ["--dataset", "mushroom", "--scale", "0.05", "--min-sup", "0.3", "--device", "cpu"]
    one = cli.main(base)
    for mesh in ("1x1", "2x2", "2x2x1"):
        assert cli.main(base + ["--mesh", mesh]).itemsets == one.itemsets
    sweep = cli.main(base + ["--mesh", "4x2", "--sweep", "0.4,0.3"])
    assert sweep[1].itemsets == one.itemsets and sweep[1].prep_shared
    served = cli.main(base + ["--mesh", "2x2", "--serve", "--sweep", "0.4,0.3"])
    assert served[1].itemsets == one.itemsets
    streamed = cli.main(base + ["--mesh", "2x1", "--append", "3"])
    assert streamed[0].itemsets == one.itemsets == host(db, one)
    capsys.readouterr()
