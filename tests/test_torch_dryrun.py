"""Port ``launch.dryrun`` vs the reference's ``launch/dryrun.py``.

The reference sets ``XLA_FLAGS`` when its dry-run module is imported, so
its numbers come from one subprocess on 8 fake CPU devices (as
``tests/test_dryrun.py`` runs it): ``n_params``, ``model_flops``,
``arg_bytes_per_device`` and the skip reasons of every arch × shape at
``--seq 512 --batch 8`` on ``2x2x2`` and ``1x1`` (abstract arguments only,
no lowering), and one prefill cell lowered and costed on ``1x1``. The port
equals the first four exactly, but for the train state's ``rng`` leaf: the
port's is a CUDA generator's 16-byte state, the reference's a (2,) uint32
key, 8 bytes. The port's own cells are traced on the meta device.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models.common import bytes_per_device, n_params
from repro_torch.models.registry import SHAPES, applicable, build_model

SEQ, BATCH = 512, 8
MESHES = ("2x2x2", "1x1")
RNG_GAP = dryrun.RNG_STATE_BYTES - 2 * 4  # the port's rng leaf less the reference's
# The prefill cell's FLOPs: the port counts its eager ops, the reference XLA's
# post-fusion HLO (hlo_cost.rollup). Both count each matmul as 2·M·N·K (95% of
# the total here); they differ in the elementwise ops: casts XLA folds away,
# the port's float32 upcasts around each einsum, and the ops of XLA's masks.
# Measured on tinyllama prefill at S=512, B=8 on 1x1: the port's count lies
# 0.24% below the reference's (8.327e12 against 8.347e12). The tolerance is 1%.
PREFILL_FLOPS_RTOL = 0.01

_REF_SCRIPT = r"""
import json
from repro.launch import dryrun as dr
from repro.launch import hlo_analysis as ha
from repro.launch.mesh import make_mesh_from_spec
from repro.configs.base import ARCH_IDS, get_config
from repro.models.common import n_params
from repro.models.registry import SHAPES, applicable, build_model
SEQ, BATCH = %d, %d
out = {}
for mesh_name in ("2x2x2", "1x1"):
    mesh = make_mesh_from_spec(mesh_name)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, s in SHAPES.items():
            ok, why = applicable(cfg, shape)
            rec = {"skipped": why}
            if ok:
                fn, args = dr.cell_args(cfg, shape, mesh, seq=SEQ, batch=BATCH)
                rec = {"n_params": int(n_params(build_model(cfg).param_specs())),
                       "model_flops": ha.model_flops(cfg, s["kind"], SEQ, BATCH, mesh.devices.size),
                       "arg_bytes": dr.bytes_per_device(args, mesh)}
            out["|".join((arch, shape, mesh_name))] = rec
rec = dr.run_cell("tinyllama_1_1b", "prefill_32k", make_mesh_from_spec("1x1"), "1x1",
                  seq=SEQ, batch=BATCH, verbose=False)
out["prefill_flops"] = rec["flops_per_device"]
print("REF" + json.dumps(out))
""" % (SEQ, BATCH)


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    env["REPRO_XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("REF"))
    return json.loads(line[3:])


@pytest.mark.parametrize("mesh_name", MESHES)
def test_counts_and_skips_match_reference(ref, mesh_name):
    mesh = dryrun.meta_mesh(mesh_name)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, s in SHAPES.items():
            want = ref["|".join((arch, shape, mesh_name))]
            ok, why = applicable(cfg, shape)
            if not ok:
                assert want == {"skipped": why}, (arch, shape)
                continue
            _, args = dryrun.cell_args(cfg, shape, mesh, seq=SEQ, batch=BATCH)
            gap = RNG_GAP if s["kind"] == "train" else 0
            got = {"n_params": n_params(build_model(cfg).param_specs()),
                   "model_flops": roofline.model_flops(cfg, s["kind"], SEQ, BATCH, mesh.devices.size),
                   "arg_bytes": bytes_per_device(args, mesh) - gap}
            assert got == want, (arch, shape, mesh_name)


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama_1_1b", "train_4k"),
    ("granite_moe", "train_4k"),
    ("xlstm_125m", "decode_32k"),
    ("zamba2_2_7b", "long_500k"),
    ("seamless_m4t_v2", "prefill_32k"),
    ("internvl2_26b", "train_4k"),
])
def test_cell_traces_small_mesh(arch, shape):
    """The reference's ``test_cell_compiles_small_mesh`` cells, traced."""
    rec = dryrun.run_cell(arch, shape, dryrun.meta_mesh("2x2x2"), "2x2x2", seq=SEQ, batch=BATCH,
                          verbose=False)
    assert "error" not in rec and "skipped" not in rec, rec
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["mem_temp_size_in_bytes"] > 0
    if SHAPES[shape]["kind"] == "train":  # the ZeRO-1 blocks move between positions
        assert rec["collective_wire_bytes"] > 0
        assert rec["collectives"]["collective-permute"] > 0


def test_skip_policy(tmp_path):
    dryrun.main(["--mesh", "2x2", "--arch", "qwen1_5_0_5b", "--shape", "long_500k", "--seq", "1024",
                 "--batch", "1", "--out", str(tmp_path), "--force"])
    recs = [json.load(open(tmp_path / f)) for f in os.listdir(tmp_path)]
    assert len(recs) == 1 and recs[0].get("skipped"), recs


def test_prefill_flops_against_reference(ref):
    rec = dryrun.run_cell("tinyllama_1_1b", "prefill_32k", dryrun.meta_mesh("1x1"), "1x1", seq=SEQ,
                          batch=BATCH, verbose=False)
    assert rec["flops_per_device"] == pytest.approx(ref["prefill_flops"], rel=PREFILL_FLOPS_RTOL)


def test_default_output_is_not_the_reference_directory():
    assert os.path.basename(os.path.normpath(dryrun.RESULTS_DIR)) == "dryrun_torch"
