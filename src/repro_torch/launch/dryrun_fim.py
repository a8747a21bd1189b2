"""Dry-run of the paper's own technique at kosarak production scale.

The counterpart of the JAX package's ``launch/dryrun_fim.py``. Where the
reference lowers HPrepost's stages on abstract shapes and costs the HLO,
the port runs them on the card (``--device cpu`` for the plain versions on
the CPU; without a CUDA device and without that flag it raises), times each
on the device, and costs it with ``launch.cost``'s dispatch trace plus the
kernels' own counts (``launch.roofline``, H100 rates). The stages are the
reference's five:

  job1          the item histogram of every shard (B3), summed over shards;
  job2_tree     rank encode and the PPC-tree build of every shard (the
                reference sizes it at ``max_nodes = (R // D)·L``; the port's
                tree holds only real nodes, sized by ``nonzero``);
  f2            the (K, K) co-occurrence matrix of every shard (B4), summed;
  wave_shuffle  one mining wave whose parents are read across the candidate
                groups (the paper's shuffle): B2 with early stop where the
                miner runs it (one data shard), else B1;
  wave_local    the same wave with locality dispatch (parents shard-local),
                early stop off: B1.

Each stage is the miner's own code (``HPrepostMiner._job1``, ``_job2``,
``_jobf2``, ``_mesh_wave``, which ``prepare`` and ``mine_prepared`` call),
on the miner's layout: shard d on position (d, 0), one wave launch a (d, g)
position. Inputs: rows from a seeded Zipf over ``n_items`` (distinct items a
row, PAD at the end), the LUT the top K items of Job 1's histogram. The
waves read the N-lists of Job 2's trees packed by the miner's
``pack_nlists_torch`` at the reference's width W (a longer list keeps its
first W codes, still a valid N-list: the kernels need each list's codes to
be an antichain of one tree). Their C candidates are the C item pairs that
co-occur most in F2's matrix (extension of the lower rank, as the miner
extends), and the (D, C, W) parent state holds counts drawn from the seed
below each code's own (see ``wave_inputs``); the reference passes abstract
shapes here, the port needs values. The waves' early-stop threshold is the median
exact support of the first position's shuffle wave.

Each stage records its roofline terms, its median wall ms on the device
over ``reps`` runs (synchronized), the ratio ms ÷ max(t_*) and its peak
device memory, under ``fim_<stage>__<mesh>.json`` in the output directory
(``results/dryrun_torch/`` by default). A mesh of several positions may put
them all on one device (``--mesh 2x2`` on ``cuda:0``): the costs and times
are then the one device's, summed over its positions.

Run: python -m repro_torch.launch.dryrun_fim --mesh 1x1 [--scale 1.0] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.core import encoding as enc
from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner, pack_nlists_torch
from repro_torch.device import resolve_device
from repro_torch.launch import cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh_from_spec

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")
STAGES = ("job1", "job2_tree", "f2", "wave_shuffle", "wave_local")


def zipf_rows(R: int, L: int, n_items: int, seed: int = 0, device="cpu", s: float = 1.0) -> torch.Tensor:
    """(R, L) int32 transactions: L draws a row from a Zipf(``s``) law over
    item ids [0, n_items), each item kept once, PAD (-1) after the row's
    distinct items. Drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = 1.0 / torch.arange(1, n_items + 1, dtype=torch.float64, device=device) ** s
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand((R, L), generator=gen, dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u).clamp_(max=n_items - 1)
    ids, _ = torch.sort(ids, dim=1)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = torch.sort(torch.where(dup, n_items, ids), dim=1).values  # repeats to the end
    return torch.where(ids == n_items, enc.PAD, ids).to(torch.int32)


def top_k_flist(supports: np.ndarray, K: int) -> enc.FList:
    """The F-list of the K most frequent items (support descending, ties
    by item id), as ``build_flist`` orders them."""
    supports = np.asarray(supports, np.int64)
    order = np.argsort(-supports, kind="stable")[:K]
    return enc.FList(items=order.astype(np.int32), supports=supports[order], n_items=len(supports),
                     min_count=int(supports[order[-1]]))


def wave_inputs(cooc: np.ndarray, counts: np.ndarray, C: int, Mb: int, seed: int = 0):
    """A wave's inputs: the C pairs (ext < base) of the largest counts in the
    (K, K) co-occurrence matrix ``cooc`` (ties in index order), each
    candidate's parent row, and the parents' state (D, C, W) int32. Each
    candidate has a parent row of its own in its group of C/Mb rows (as
    locality dispatch lays out a wave), and that row holds, on each of the
    base item's codes, a count drawn from the seed between 0 and the code's
    own count (``counts``: (D, K, W), the count plane): a parent itemset's
    support on a code never exceeds the code's. -> (state, parent,
    parent_local, base, ext), the index rows int64."""
    upper = np.triu(cooc, 1).ravel()
    top = np.sort(np.argsort(-upper, kind="stable")[:C])
    ext, base = np.divmod(top, cooc.shape[0])
    rng = np.random.default_rng(seed)
    Cs = C // Mb
    local = np.concatenate([rng.permutation(Cs) for _ in range(Mb)])
    parent = np.arange(C) // Cs * Cs + local
    state = np.zeros((counts.shape[0], C, counts.shape[2]), np.int32)
    for d in range(counts.shape[0]):
        cnt = counts[d][base]
        state[d, parent] = np.floor(rng.random(cnt.shape) * (cnt + 1)).astype(np.int32)
    return state, parent.astype(np.int64), local.astype(np.int64), base.astype(np.int64), ext.astype(np.int64)


def _timed(fn, device, reps: int) -> tuple[float, list[float], int]:
    """-> (median wall ms, each run's ms, peak device bytes of one run)."""
    cuda = device.type == "cuda"
    ms = []
    peak = 0
    for i in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            if i == 0:
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if cuda and i == 0:
            peak = torch.cuda.max_memory_allocated(device) - base
    return statistics.median(ms), ms, peak


def run(mesh=None, mesh_name: str = "1x1", *, R: int = 1_048_576, L: int = 48, n_items: int = 41_270,
        K: int = 2048, W: int = 512, C: int = 8192, device="cuda", out_dir: str = RESULTS_DIR,
        seed: int = 0, reps: int = 5, outputs: dict | None = None) -> dict:
    """Time and cost the five stages on ``mesh`` (the 1×1 mesh on
    ``device`` by default). -> stage name -> record. ``outputs``, when
    given, receives the stages' inputs (``"inputs"``), each stage's outputs
    (under its name) and the stages themselves as callables (``"stages"``)."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh_from_spec("1x1", devices=[dev])
    miner = HPrepostMiner(config=HPrepostConfig(), mesh=mesh,
                          data_axis=("pod", "data") if "pod" in mesh.shape else "data")
    D, Mb = miner.D, miner._Mb
    R = max(R // D, 1) * D
    C = max(C // (256 * Mb), 1) * 256 * Mb
    Cs = C // Mb
    on = miner.device  # the reduce position's device: data is made there

    rows = zipf_rows(R, L, n_items, seed, on).cpu().numpy()
    shard_rows = miner._shard_rows(rows)
    hist = miner._job1(shard_rows, n_items)
    fl = top_k_flist(hist.cpu().numpy(), K)
    lut = torch.from_numpy(fl.rank_lut())
    ranked, trees = miner._job2(shard_rows, lut, K, n_items)
    shard_planes = [pack_nlists_torch(*t, K, W)[0].permute(2, 0, 1).contiguous() for t in trees]
    planes = miner._position_planes(shard_planes)
    planes_h = np.stack([p.cpu().numpy() for p in shard_planes])
    del trees
    state_h, parent, parent_local, base, ext = wave_inputs(
        miner._jobf2(ranked, K).cpu().numpy(), planes_h[:, 2], C, Mb, seed)
    prev = [[torch.from_numpy(state_h[d, g * Cs:(g + 1) * Cs]).to(miner._grid[d, g]) for g in range(Mb)]
            for d in range(D)]
    idx_shuffle = np.stack([parent, base, ext])
    idx_local = np.stack([parent_local, base, ext])
    live = np.full(Mb, Cs)
    # the early-stop threshold: the median exact support of position (0, 0)'s
    # shuffle wave, from the plain version
    from repro_torch.kernels.nlist_intersect.ref import nlist_wave_ref

    state0 = prev[0][0] if Mb == 1 else torch.cat([p.to(on) for p in prev[0]])
    idx0 = torch.from_numpy(np.ascontiguousarray(idx_shuffle[:, :Cs])).to(on)
    stop = max(1, int(nlist_wave_ref(planes[0][0], state0, idx0, Cs)[1].to(torch.float64).median()))
    stop_count = stop if D == 1 else 0  # as the miner: early stop only where supports are final

    stages = {
        "job1": lambda: miner._job1(shard_rows, n_items),
        "job2_tree": lambda: miner._job2(shard_rows, lut, K, n_items),
        "f2": lambda: miner._jobf2(ranked, K),
        "wave_shuffle": lambda: miner._mesh_wave(planes, prev, idx_shuffle, live, 3, False, stop_count),
        "wave_local": lambda: miner._mesh_wave(planes, prev, idx_local, live, 3, True, 0),
    }
    if outputs is not None:
        outputs["stages"] = stages
        outputs["inputs"] = dict(rows=rows, lut=fl.rank_lut(), planes=planes_h, state=state_h,
                                 idx_shuffle=idx_shuffle, idx_local=idx_local, stop=stop,
                                 stop_count=stop_count, R=R, C=C, K=K, W=W, D=D, Mb=Mb)
    results = {}
    for name, fn in stages.items():
        out, pc = cost.trace(fn)
        if outputs is not None:
            outputs[name] = out
        del out
        ms, runs, peak = _timed(fn, on, reps)
        roof = rl.analyze(pc)
        results[name] = {
            "arch": f"hprepost_{name}", "shape": "fim_wave", "mesh": mesh_name,
            "n_positions": int(mesh.devices.size), "n_devices": len(mesh.distinct_devices()),
            "device": torch.cuda.get_device_name(on) if on.type == "cuda" else on.type,
            "R": R, "L": L, "n_items": n_items, "K": K, "W": W, "C": C,
            "max_nodes": (R // D) * L, "stop_count": stop_count if name == "wave_shuffle" else 0,
            "flops_per_device": pc.flops, "hbm_bytes_per_device": pc.hbm_bytes,
            "collective_wire_bytes": pc.wire_bytes, "collectives": rl.collective_bytes(pc.coll_payload),
            "t_compute": roof.t_compute, "t_memory": roof.t_memory,
            "t_collective": roof.t_collective, "bottleneck": roof.bottleneck,
            "ms": ms, "ms_runs": runs, "ratio": ms / (roof.t_bound * 1e3) if roof.t_bound else math.inf,
            "peak_device_bytes": peak, "n_ops": pc.n_ops,
        }
        print(f"[fim {name} × {mesh_name}] {ms:.3f} ms -> {roof.bottleneck} (c {roof.t_compute:.2e} "
              f"m {roof.t_memory:.2e} x {roof.t_collective:.2e} s), {results[name]['ratio']:.1f}x the "
              f"bound, peak {peak / 2**20:.1f} MiB", flush=True)

    os.makedirs(out_dir, exist_ok=True)
    for name, rec in results.items():
        with open(os.path.join(out_dir, f"fim_{name}__{mesh_name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM, every position on --device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = math.prod(int(x) for x in args.mesh.split("x"))
    mesh = make_mesh_from_spec(args.mesh, devices=[dev] * n)
    s = args.scale
    run(mesh, args.mesh, R=int(1_048_576 * s), C=int(8192 * s) or 256, device=dev, out_dir=args.out)


if __name__ == "__main__":
    main()
