"""Dry-run of the LM scaffold's cells: trace every (arch × shape × mesh)
cell on the meta device and record its roofline terms on one H100.

The counterpart of the JAX package's ``launch/dryrun.py``. For each cell it
builds allocation-free stand-ins for every input (``AbstractTensor``: a
meta tensor and its ``NamedSharding``, for the parameters, the ZeRO-1
moments, the batch and the KV cache), runs the cell's step on them once
under ``launch.cost``'s dispatch-level cost model, and writes the cost,
the H100 roofline (``launch.roofline``) and the per-device argument bytes to
one JSON a cell under ``results/dryrun_torch/``. Nothing is allocated or
computed: the meta device plays the part of the reference's fake devices,
and a mesh of any shape (``16x16``, ``2x16x16``) puts every position on it.

Run (one cell):  python -m repro_torch.launch.dryrun --mesh 16x16 --arch tinyllama_1_1b --shape train_4k
Run (a sweep):   python -m repro_torch.launch.dryrun --all --mesh 16x16 [--jobs 8]

Skipped cells carry the reference's reason (``models.registry.applicable``).

Per-device numbers, a deliberate difference: the reference's are those of
XLA's SPMD-partitioned program, one device's share. The port has no
partitioner. As in the reference's own ``--mesh`` training run, it computes
the step on the mesh's first position with the ZeRO-1 moments held as blocks
on their positions. So ``flops_per_device`` and ``hbm_bytes_per_device``
are the busiest position's cost in the port's program (the first: the whole
forward and backward, and its moment blocks), not a global count over the
devices; ``collective_wire_bytes`` counts the bytes that leave a position in
it, and ``collectives`` the same payloads under the reference's keys and
ring rule. ``n_params``, ``model_flops_per_device`` and
``arg_bytes_per_device`` (each leaf's bytes over its spec's split) follow
the reference's definitions and equal its numbers, but for the ``rng``
leaf: the port's is a CUDA generator's state, 16 bytes, where the
reference's is a (2,) uint32 key. ``mem_argument_size_in_bytes`` is what
the first position holds of the arguments, ``mem_temp_size_in_bytes`` the
trace's peak live bytes. ``trace_s`` takes the place of ``lower_s`` /
``compile_s``; there are no ``xla_*`` keys. The reference's ``--multi-pod``
and ``--both-meshes`` name TPU pods and are not ported; ``--jobs`` runs the
cells in that many processes.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh_from_spec
from repro_torch.models.common import (
    AbstractTensor,
    abstract_params,
    bytes_per_device,
    n_params,
    tree_leaves,
    tree_map,
)
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import SHAPES, applicable, batch_specs, build_model, cache_specs_for
from repro_torch.sharding.rules import MeshRules, NamedSharding, PartitionSpec
from repro_torch.training.optim import moment_specs
from repro_torch.training.step import TrainConfig, make_train_step, moment_shardings

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")
RNG_STATE_BYTES = 16  # a CUDA torch.Generator's state: its seed and offset, 8 bytes each


def meta_mesh(spec: str):
    """The mesh ``spec`` ("16x16", "2x16x16", ...) with every position on
    the meta device."""
    n = math.prod(int(x) for x in spec.split("x"))
    return make_mesh_from_spec(spec, devices=["meta"] * n)


def _replicated(mesh, shape, dtype) -> AbstractTensor:
    return AbstractTensor(torch.empty(shape, dtype=dtype, device="meta"),
                          NamedSharding(mesh, PartitionSpec(*([None] * len(shape)))))


def abstract_state(model, rules) -> dict:
    """Abstract train state: params + ZeRO-sharded AdamW moments."""
    pspecs = model.param_specs()
    mspecs = moment_specs(pspecs, rules)
    return {
        "params": abstract_params(pspecs, rules),
        "opt": {
            "m": abstract_params(mspecs, rules),
            "v": abstract_params(mspecs, rules),
            "step": _replicated(rules.mesh, (), torch.int32),
        },
        "rng": _replicated(rules.mesh, (RNG_STATE_BYTES,), torch.uint8),
    }


def _tensors(tree):
    return tree_map(lambda a: a.tensor, tree)


def cell_args(cfg, shape_name, mesh, seq=None, batch=None):
    """(fn, abstract_args) for one cell: ``fn(*abstract_args)`` runs the
    cell's step on the arguments' meta tensors (laid out as the step takes
    them, uncharged) and returns its result."""
    rules = MeshRules(mesh)
    model = build_model(cfg)
    kind = SHAPES[shape_name]["kind"]
    batch_abs = abstract_params(batch_specs(cfg, shape_name, seq=seq, batch=batch), rules)
    if kind == "train":
        step = make_train_step(model, TrainConfig(), rules)
        shardings = moment_shardings(model, rules)

        def train(state_abs, batch_abs):
            with cost.uncharged():  # the step's layout of its inputs: no work of the step
                moments = {name: {k: shardings[k].split(t)
                                  for k, t in params_from_reference(cfg, _tensors(state_abs["opt"][name])).items()}
                           for name in ("m", "v")}
                state = {"params": params_from_reference(cfg, _tensors(state_abs["params"])),
                         "opt": {**moments, "step": state_abs["opt"]["step"].tensor},
                         "rng": state_abs["rng"].tensor}
            return step(state, _tensors(batch_abs))

        return train, (abstract_state(model, rules), batch_abs)
    params_abs = abstract_params(model.param_specs(), rules)
    cache_abs = abstract_params(cache_specs_for(cfg, shape_name, seq=seq, batch=batch), rules)

    def serve(params_abs, batch_abs, cache_abs):
        with torch.no_grad():
            return torch.func.functional_call(
                model, params_from_reference(cfg, _tensors(params_abs)),
                (kind, _tensors(batch_abs), _tensors(cache_abs)), strict=True)

    return serve, (params_abs, batch_abs, cache_abs)


def first_position_bytes(args, mesh) -> int:
    """What the mesh's first position holds of a cell's arguments: the
    moments as their blocks, everything else whole."""
    total = 0
    for tree in args:
        if isinstance(tree, dict) and "opt" in tree:
            total += bytes_per_device(tree["opt"], mesh)
            tree = {k: v for k, v in tree.items() if k != "opt"}
        total += sum(math.prod(a.shape) * a.tensor.element_size() for a in tree_leaves(tree) if a is not None)
    return total


def run_cell(arch, shape_name, mesh, mesh_name, seq=None, batch=None, verbose=True):
    cfg = get_config(arch)
    ok, why = applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skipped": why}
    t0 = time.time()
    fn, args = cell_args(cfg, shape_name, mesh, seq=seq, batch=batch)
    arg_bytes_dev = bytes_per_device(args, mesh)
    out, pc = cost.trace(fn, *args)
    del out
    t_trace = time.time() - t0
    roof = rl.analyze(pc)
    s = SHAPES[shape_name]
    n_dev = int(mesh.devices.size)
    mf = rl.model_flops(cfg, s["kind"], seq or s["seq"], batch or s["global_batch"], n_dev)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "n_params": int(n_params(build_model(cfg).param_specs())),
        "trace_s": round(t_trace, 1),
        "n_ops": pc.n_ops,
        "flops_per_device": pc.flops,
        "tensor_core_flops_per_device": pc.mm_flops,
        "hbm_bytes_per_device": pc.hbm_bytes,
        "collective_wire_bytes": pc.wire_bytes,
        "t_compute": roof.t_compute,
        "t_memory": roof.t_memory,
        "t_collective": roof.t_collective,
        "bottleneck": roof.bottleneck,
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / pc.flops if pc.flops else 0.0,
        "arg_bytes_per_device": arg_bytes_dev,
        "collectives": rl.collective_bytes(pc.coll_payload),
        "mem_argument_size_in_bytes": first_position_bytes(args, mesh),
        "mem_temp_size_in_bytes": int(pc.peak_bytes),
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] trace {t_trace:.1f}s ({pc.n_ops} ops) | "
              f"flops/dev {pc.flops:.3g} hbm {pc.hbm_bytes:.3g} coll {pc.wire_bytes:.3g} "
              f"-> {roof.bottleneck}", flush=True)
    return rec


def _cell_job(job):
    """One cell in a worker process -> (tag, record, failed)."""
    arch, shape, mesh_spec, mesh_name, seq, batch, path = job
    tag = f"{arch}__{shape}__{mesh_name}"
    try:
        rec = run_cell(arch, shape, meta_mesh(mesh_spec), mesh_name, seq=seq, batch=batch)
        failed = False
    except Exception as e:  # a failing cell is a bug: record + surface
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "error": f"{type(e).__name__}: {e}"}
        failed = True
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return tag, failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="16x16", help="e.g. 16x16, 4x2 or 2x2x2 (positions on meta)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced in this many processes")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    jobs = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{args.mesh}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[cached] {tag}")
                continue
            jobs.append((arch, shape, args.mesh, args.mesh, args.seq, args.batch, path))
    if args.jobs > 1 and len(jobs) > 1:
        # the longest cells first, so that no process is left with one at the end
        order = {"train": 0, "prefill": 1, "decode": 2}
        jobs.sort(key=lambda j: order[SHAPES[j[1]]["kind"]])
        with multiprocessing.get_context("spawn").Pool(min(args.jobs, len(jobs))) as pool:
            results = pool.map(_cell_job, jobs, chunksize=1)
    else:
        results = [_cell_job(j) for j in jobs]
    failures = [tag for tag, failed in results if failed]
    if failures:
        print("FAILED cells:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
