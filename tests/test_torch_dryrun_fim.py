"""Port ``launch.dryrun_fim`` vs the reference's jitted HPrepost stages on a
1×1 mesh (``backend="jnp"``): at ``--scale 0.001`` on the CPU each of the
five stages' outputs equals the reference stage's on the same inputs, bit
for bit (the early-stop wave on the candidates that survive, since the
reference's ``jnp`` path does not mask; see ``test_waves_match_reference``),
and all five records are written. The reference's own
``launch/dryrun_fim.py`` sets ``XLA_FLAGS`` at import, so its stages are
called through ``repro.core.hprepost.HPrepostMiner`` directly."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.hprepost import HPrepostConfig as JConfig
from repro.core.hprepost import HPrepostMiner as JMiner
from repro_torch.launch import dryrun_fim

SCALE = 0.001
RECORD_KEYS = ("flops_per_device", "hbm_bytes_per_device", "collective_wire_bytes", "t_compute",
               "t_memory", "t_collective", "bottleneck", "ms", "ratio", "peak_device_bytes")


@pytest.fixture(scope="module")
def fim(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("fim")
    outputs = {}
    recs = dryrun_fim.run(None, "1x1", R=int(1_048_576 * SCALE), C=int(8192 * SCALE) or 256,
                          device="cpu", out_dir=str(out_dir), reps=1, outputs=outputs)
    return recs, outputs, out_dir


@pytest.fixture(scope="module")
def ref_miner():
    from repro.compat import make_mesh

    return JMiner(make_mesh((1, 1), ("data", "model")), config=JConfig(backend="jnp"))


def test_records_written(fim):
    recs, _, out_dir = fim
    assert set(recs) == set(dryrun_fim.STAGES)
    for name in dryrun_fim.STAGES:
        rec = json.loads((out_dir / f"fim_{name}__1x1.json").read_text())
        assert rec["arch"] == f"hprepost_{name}" and rec["mesh"] == "1x1"
        for k in RECORD_KEYS:
            assert k in rec, (name, k)
        assert rec["hbm_bytes_per_device"] > 0 and rec["ms"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert (rec["R"], rec["K"], rec["W"], rec["C"]) == (1048, 2048, 512, 256)


def test_job1_and_job2_match_reference(fim, ref_miner):
    _, out, _ = fim
    inp = out["inputs"]
    rows = ref_miner._shard(inp["rows"], P("data", None))
    hist = np.asarray(ref_miner._job1(rows, n_items=41_270))
    np.testing.assert_array_equal(out["job1"].numpy(), hist)

    R, L = inp["rows"].shape
    ranked, item, count, pre, post, _ = (np.asarray(x) for x in ref_miner._job2(
        rows, jnp.asarray(inp["lut"]), max_nodes=R * L, k=2048, n_items=41_270))
    t_ranked, trees = out["job2_tree"]
    np.testing.assert_array_equal(t_ranked[0].numpy(), ranked[0])
    valid = item[0] >= 0
    for got, want in zip(trees[0], (item[0], count[0], pre[0], post[0])):
        np.testing.assert_array_equal(got.numpy(), want[valid])


def test_f2_matches_reference(fim, ref_miner):
    _, out, _ = fim
    ranked = out["job2_tree"][0][0].numpy()
    want = np.asarray(ref_miner._jobf2(ref_miner._shard(ranked[None], P("data", None, None)), k=2048))
    np.testing.assert_array_equal(out["f2"].numpy(), want)


@pytest.mark.parametrize("stage", ["wave_shuffle", "wave_local"])
def test_waves_match_reference(fim, ref_miner, stage):
    """The reference's jitted wave stage with ``backend="jnp"`` computes the
    exact intersections (its early-stop masking runs only in its Pallas
    kernels): the port's B1 stage equals it everywhere, and its early-stop
    (B2) stage on every candidate that reaches the threshold, and the rest
    equal the reference's masked plain version (its Pallas B2's contract)
    on the same gathered operands, with the dead candidates zeroed."""
    from repro.kernels.nlist_intersect.ref import nlist_intersect_masked_ref

    _, out, _ = fim
    inp = out["inputs"]
    idx = inp["idx_shuffle"] if stage == "wave_shuffle" else inp["idx_local"]
    stop = inp["stop_count"] if stage == "wave_shuffle" else 0
    assert stage == "wave_local" or stop > 0  # one data shard: the shuffle wave runs B2
    cfg = ref_miner.cfg
    packed = jnp.asarray(np.transpose(inp["planes"], (0, 2, 3, 1)))  # (D, K, W, 3)
    fn = ref_miner._wave if stage == "wave_shuffle" else ref_miner._wave_local
    new, sup = fn(packed, jnp.asarray(inp["state"]), *(jnp.asarray(r.astype(np.int32)) for r in idx),
                  np.int32(stop), la_block=cfg.la_block, ly_block=cfg.ly_block,
                  batch_block=cfg.batch_block, backend="jnp", early_stop=stop > 0)
    new, sup = np.asarray(new)[0], np.asarray(sup)
    t_new, t_sup = out[stage][0][0][0].numpy(), out[stage][1][0].numpy()
    alive = t_sup >= stop
    np.testing.assert_array_equal(t_new[alive], new[alive])
    np.testing.assert_array_equal(t_sup[alive], sup[alive])
    if stop:
        assert 0 < alive.sum() < len(alive)  # the threshold (a median) kills some candidates
        planes, state = inp["planes"][0], inp["state"][0]
        a, y = planes[:, idx[2]], planes[:, idx[1]]
        want, wsup = nlist_intersect_masked_ref(*map(jnp.asarray, (a[0], a[1], a[2], y[0], y[1],
                                                                   state[idx[0]])),
                                                stop, la_block=cfg.la_block)
        np.testing.assert_array_equal(t_new, np.asarray(want))
        np.testing.assert_array_equal(t_sup, np.asarray(wsup))


def test_no_cuda_raises_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_fim.main(["--mesh", "1x1", "--scale", "0.001"])
