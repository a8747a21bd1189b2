"""The port's ``HPrepostMiner`` on D×M meshes against the reference's on the
same mesh shapes: itemsets, the ``PreparedDB.to_host()`` payload key by key
(dtype and bytes), the planning counters, the stage counters and
``peak_bytes``, with no tolerance.

The reference needs one JAX device per position, which the JAX runtime
fixes when it starts, so it runs once per module in a subprocess with
eight host devices and ``backend="jnp"`` and writes every case's results to
an ``.npz``. The port runs in process with every position on ``"cpu"``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import hprepost
from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner, PreparedDB
from repro_torch.core.prepost import mine_prepost
from repro_torch.data.synth import load, random_db
from repro_torch.launch.mesh import make_mesh, make_mesh_from_spec

SRC = str(Path(__file__).resolve().parents[1] / "src")
PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset")
DM = ["data", "model"]


def _case(id, shape, data, min_count, axes=DM, data_axis="data", max_k=None, **cfg):
    return dict(id=id, shape=list(shape), axes=list(axes), data_axis=data_axis, data=data,
                min_count=min_count, max_k=max_k, cfg=cfg)


RAND = [["random", s, 100, 12, 6] for s in range(4)]
MUSHROOM = ["load", "mushroom", 0.03]
CASES = [
    # tests/test_hprepost.py's multi-device cases: four seeds x mode A/B on
    # (4, 2), and the pod mesh with rows sharded over two axes
    *[_case(f"seed{s}-{'B' if b else 'A'}-4x2", (4, 2), RAND[s], 2, candidate_unit=8,
            partition_candidates=b) for s in range(4) for b in (True, False)],
    _case("pod-2x2x2", (2, 2, 2), ["random", 7, 64, 10, 5], 2, axes=["pod", "data", "model"],
          data_axis=["pod", "data"], candidate_unit=8),
    _case("shuffle-unpipelined-2x2", (2, 2), RAND[0], 2, candidate_unit=8,
          locality_dispatch=False, pipeline_waves=False),
    _case("exact-2x1", (2, 1), RAND[1], 3, candidate_unit=8, early_stop=False),
    _case("early-stop-1x2", (1, 2), RAND[2], 2, candidate_unit=8),
    _case("max-k1-2x2", (2, 2), RAND[3], 2, max_k=1, candidate_unit=8),
    _case("max-k2-2x2", (2, 2), RAND[3], 2, max_k=2, candidate_unit=8),
    # more shards than rows: the tail shards hold PAD rows only
    _case("tiny-4x2", (4, 2), ["random", 5, 3, 8, 4], 1, candidate_unit=8,
          partition_candidates=True),
    # dense: uneven locality buckets, waves past k = 4
    _case("mushroom-4x2", (4, 2), MUSHROOM, 45),
    _case("mushroom-4x2-shuffle", (4, 2), MUSHROOM, 45, locality_dispatch=False),
]
BY_ID = {c["id"]: c for c in CASES}

_REF = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.compat import make_mesh
    from repro.core.hprepost import HPrepostConfig, HPrepostMiner
    from repro.data.synth import load, random_db

    PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset")

    def rows_of(spec):
        if spec[0] == "random":
            _, seed, R, n, L = spec
            return random_db(np.random.default_rng(seed), R, n, L), n
        return load(spec[1], scale=spec[2])

    out, miners = {}, {}
    for c in json.loads(sys.argv[2]):
        da = tuple(c["data_axis"]) if isinstance(c["data_axis"], list) else c["data_axis"]
        cfg = HPrepostConfig(backend="jnp", **c["cfg"])
        key = (tuple(c["shape"]), tuple(c["axes"]), da, cfg)
        if key not in miners:  # one miner per mesh and config: its jits stay warm
            mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]))
            miners[key] = HPrepostMiner(mesh, data_axis=da, config=cfg)
        m = miners[key]
        rows, n_items = rows_of(c["data"])
        before = dict(m.stage_counters)
        payload = m.prepare(rows, n_items, c["min_count"]).to_host()
        res = m.mine(rows, n_items, c["min_count"], max_k=c["max_k"])
        meta = dict(
            itemsets=sorted([list(k), v] for k, v in res.itemsets.items()),
            n_explicit=res.n_explicit, total_count=res.total_count,
            peak_bytes=int(res.peak_bytes), flist=[int(x) for x in res.flist_items],
            counters={k: v - before[k] for k, v in m.stage_counters.items()},
            planning={k: m.last_stage_times[k] for k in PLANNING},
            stage_keys=sorted(m.last_stage_times),
            scalars={k: v for k, v in payload.items() if not isinstance(v, np.ndarray)},
        )
        out[c["id"] + "/meta"] = np.array(json.dumps(meta))
        for k, v in payload.items():
            if isinstance(v, np.ndarray):
                out[c["id"] + "/" + k] = v
    np.savez(sys.argv[1], **out)
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case through the reference, once: ``{case id: (meta, arrays)}``."""
    path = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF, str(path), json.dumps(CASES)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = {}
    with np.load(path) as z:
        for name in z.files:
            cid, key = name.split("/", 1)
            meta, arrays = got.setdefault(cid, ({}, {}))
            if key == "meta":
                meta.update(json.loads(str(z[name])))
            else:
                arrays[key] = z[name]
    return got


def rows_of(spec):
    if spec[0] == "random":
        _, seed, R, n, L = spec
        return random_db(np.random.default_rng(seed), R, n, L), n
    return load(spec[1], scale=spec[2])


def cpu_mesh(shape, axes=DM):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def port_miner(c, **cfg):
    da = tuple(c["data_axis"]) if isinstance(c["data_axis"], list) else c["data_axis"]
    return HPrepostMiner(config=HPrepostConfig(**{**c["cfg"], **cfg}),
                         mesh=cpu_mesh(c["shape"], c["axes"]), data_axis=da)


def assert_payload(got: dict, meta: dict, arrays: dict):
    assert sorted(got) == sorted([*meta["scalars"], *arrays])
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            w = arrays[k]
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert v.tobytes() == w.tobytes(), k
        else:
            w = meta["scalars"][k]
            assert type(v) is type(w) and v == w, k


@pytest.mark.parametrize("cid", list(BY_ID))
def test_mesh_matches_reference(ref, cid):
    c = BY_ID[cid]
    meta, arrays = ref[cid]
    rows, n_items = rows_of(c["data"])
    m = port_miner(c)
    assert (m.D, m.M) == (int(np.prod(c["shape"][:-1])), c["shape"][-1])
    payload = m.prepare(rows, n_items, c["min_count"]).to_host()
    assert payload["n_shards"] == m.D
    assert_payload(payload, meta, arrays)
    res = m.mine(rows, n_items, c["min_count"], max_k=c["max_k"])
    assert sorted([list(k), v] for k, v in res.itemsets.items()) == meta["itemsets"]
    assert (res.n_explicit, res.total_count, res.peak_bytes) == (
        meta["n_explicit"], meta["total_count"], meta["peak_bytes"])
    assert [int(x) for x in res.flist_items] == meta["flist"]
    assert m.stage_counters == meta["counters"]
    assert {k: m.last_stage_times[k] for k in PLANNING} == meta["planning"]
    assert sorted(m.last_stage_times) == meta["stage_keys"]
    want = mine_prepost(rows, n_items, c["min_count"], max_k=c["max_k"]).itemsets
    assert res.itemsets == want


def _spy(monkeypatch, name):
    """Record each call of ``hprepost.<name>`` (its args and kwargs)."""
    calls = []
    real = getattr(hprepost, name)

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(hprepost, name, spy)
    return calls


@pytest.mark.parametrize("cid", ["seed0-B-4x2", "seed0-A-4x2", "early-stop-1x2", "pod-2x2x2",
                                 "mushroom-4x2", "shuffle-unpipelined-2x2"])
def test_launches_per_position(monkeypatch, cid):
    """Each prepare runs B3 and B4 once per data shard, on the shard's rows;
    each wave runs D·Mb launches (Mb the candidate groups: M in mode B, else
    1), each on its group's own Cs slots with its live prefix; B2 only where
    D = 1. The dense locality case places candidates in uneven groups."""
    c = BY_ID[cid]
    rows, n_items = rows_of(c["data"])
    m = port_miner(c)
    hist, cooc = _spy(monkeypatch, "item_histogram"), _spy(monkeypatch, "cooccurrence_matrix")
    waves = _spy(monkeypatch, "nlist_wave")
    prep = m.prepare(rows, n_items, c["min_count"])
    Rs = -(-len(rows) // m.D)
    assert len(hist) == len(cooc) == m.D
    assert all(a[0].shape == (Rs, rows.shape[1]) for a, _ in hist + cooc)
    m.mine_prepared(prep, c["min_count"])
    Mb = m.M if c["cfg"].get("partition_candidates", True) else 1
    assert m._Mb == Mb and len(waves) == m.stage_counters["waves"] * m.D * Mb > 0
    uneven = False
    for w in range(m.stage_counters["waves"]):
        calls = waves[w * m.D * Mb:(w + 1) * m.D * Mb]
        (Cs,) = {a[2].shape[1] for a, _ in calls}
        assert all(0 <= a[3] <= Cs for a, _ in calls)
        live = [a[3] for a, _ in calls[:Mb]]  # d = 0: one launch per group
        assert [a[3] for a, _ in calls] == live * m.D
        uneven |= len(set(live)) > 1 and w > 0
        assert all(kw["early_stop"] is (m.D == 1 and m.cfg.early_stop) for _, kw in calls)
    if cid == "mushroom-4x2":
        assert uneven


def test_one_by_one_mesh_is_the_device_path():
    """``mesh=None`` is the 1×1 mesh on ``device``: the same payload,
    itemsets, counters and peak as an explicit 1×1 mesh."""
    rows, n_items = load("mushroom", scale=0.03)
    a = HPrepostMiner("cpu", HPrepostConfig())
    b = HPrepostMiner(mesh=cpu_mesh((1, 1)))
    assert (a.D, a.M, a._Mb, a.device) == (b.D, b.M, b._Mb, b.device) == (1, 1, 1, torch.device("cpu"))
    pa, pb = a.prepare(rows, n_items, 45), b.prepare(rows, n_items, 45)
    for k, v in pa.to_host().items():
        w = pb.to_host()[k]
        assert (v.tobytes() == w.tobytes()) if isinstance(v, np.ndarray) else v == w, k
    ra, rb = a.mine_prepared(pa, 45), b.mine_prepared(pb, 45)
    assert ra.itemsets == rb.itemsets and ra.peak_bytes == rb.peak_bytes
    assert a.last_stage_times.keys() == b.last_stage_times.keys()
    with pytest.raises(ValueError, match="not both"):
        HPrepostMiner("cpu", mesh=cpu_mesh((1, 1)))


def test_per_shard_row_guard(monkeypatch):
    """The int32 count bound holds per data shard: rows that trip it on
    one shard pass on four, whose shards hold a quarter each."""
    monkeypatch.setattr(hprepost, "EXACT_MAX", 50)
    rows = random_db(np.random.default_rng(0), 120, 12, 6)
    for shape, fails in (((1, 2), True), ((2, 2), True), ((4, 1), False)):
        m = HPrepostMiner(mesh=cpu_mesh(shape))
        m.backend = "cuda"  # the guard applies to the CUDA kernels' counts
        if fails:
            with pytest.raises(ValueError, match=f"per-shard row count {-(-120 // m.D)}"):
                m.prepare(rows, 12, 3)
        else:
            assert m.prepare(rows, 12, 3).n_shards == 4


def test_from_host_keeps_the_shard_count(ref):
    """A reference (4, 2) payload restores onto any port mesh with D = 4
    (the model axis is free) and serves the same mine; any other D is
    refused."""
    c = BY_ID["mushroom-4x2"]
    meta, arrays = ref["mushroom-4x2"]
    payload = {**meta["scalars"], **arrays}
    rows, n_items = rows_of(c["data"])
    for shape in ((4, 2), (4, 1)):
        m = HPrepostMiner(mesh=cpu_mesh(shape))
        back = PreparedDB.from_host(payload, m).to_host()
        # C comes back int64, as the reference's from_host makes it
        assert back["C"].dtype == np.int64
        assert_payload({**back, "C": back["C"].astype(arrays["C"].dtype)}, meta, arrays)
        prep = PreparedDB.from_host(payload, m)
        res = m.mine_prepared(prep, c["min_count"])
        assert sorted([list(k), v] for k, v in res.itemsets.items()) == meta["itemsets"]
    for shape in ((2, 2), (1, 1), (1, 4)):
        with pytest.raises(ValueError, match="data shard"):
            PreparedDB.from_host(payload, HPrepostMiner(mesh=cpu_mesh(shape)))


def test_make_mesh():
    m = make_mesh_from_spec("2x4x2", ["cpu"] * 16)
    assert m.axis_names == ("pod", "data", "model") and m.shape == {"pod": 2, "data": 4, "model": 2}
    assert m.devices.size == 16 and m.distinct_devices() == [torch.device("cpu")]
    assert make_mesh_from_spec("4x2", ["cpu"] * 8).axis_names == ("data", "model")
    grid = m.grid(("pod", "data"), "model")
    assert grid.shape == (8, 2)
    assert make_mesh((2, 3), DM, ["cpu"] * 6).grid(("data",), None).shape == (2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="Number of devices"):
            make_mesh((2, 1), DM)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1, 1), DM, ["cuda"])
    with pytest.raises(ValueError, match="positions"):
        make_mesh((2, 2), DM, ["cpu"] * 3)
    with pytest.raises(ValueError, match="no axis"):
        HPrepostMiner(mesh=cpu_mesh((2, 2)), data_axis="pod")
