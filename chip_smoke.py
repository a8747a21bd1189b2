"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: every CUDA kernel under src/repro_torch/csrc, compiled by nvcc
     for sm_90a (one process per source, all at once);
  3. kernels: each kernel at the main path's shapes, held to exact equality
     with its plain PyTorch version on the card, and timed beside it (and
     beside one PyTorch library call where one computes the same function:
     for B4 the weighted one-hot product, and with all weights 1 its exact
     bf16 and int8 tensor-core forms, ``cooccur_library``; at every shape
     B4 runs also the instance it takes, its bucketing pass alone, the
     dense-product floor, its scratch and each instance's ptxas report,
     ``cooccur_extras``);
     B1/B2 through the wave entry the miner calls, then held to the padding
     contract on soiled padding slots (``padding_contract``: parent states
     of 0-4, count + 1 and counts on padding only, A counts on padding, B2
     at three min_counts x la_block 128/256/512, 256- and 1,024-thread
     blocks) at the mushroom level-2 wave and at a 1,024 x W 512 wave on
     Job 2's production N-lists (``fim_wave``); B4 also on a weighted,
     repeated-item case at pumsb's shape, B3 on every dataset's rows and on
     the cases the main path does not reach (``hist_cases``);
  4. end to end: one-shot hprepost mines (on the card, full dataset scale)
     through ``MiningEngine(device="cuda", prep_cache_bytes=0)``, so each
     pays for its own prep, on mushroom@0.15 with early stop on and off,
     pumsb@0.15 and kosarak@0.01; each itemsets dict must equal the host
     PrePost miner's, and every kernel's launch counter must have moved in
     this phase;
  5. where the time goes: each mine again, warm, under torch.profiler —
     device busy time, idle share and the top device ops;
  6. the resident engine: ``MiningEngine(device="cuda").sweep`` on mushroom
     at 0.3/0.2/0.15 (early stop on, then off on the cached prep) and on
     kosarak at 0.02/0.01, one prepare per dataset (B3 and B4 launched once
     each per prepare, a wave kernel on every threshold); a snapshot warm
     start of the kosarak sweep in a fresh engine (no prepare, no prep
     launch); the kernel tuner cold, then warm with zero trials; and an LRU
     eviction that returns the evicted prep's device memory. Every itemsets
     dict must equal the host PrePost miner's;
  7. the resident service: one ``MiningService(device="cuda")`` takes, from
     three producer threads inside one batch window, the mushroom sweep at
     0.3/0.2/0.15, pumsb at 0.15, kosarak at 0.02/0.01 and one host apriori
     on mushroom at 0.3 — three device groups, each prepared once (one B3
     and one B4 launch per group), at least one prepare overlapped with an
     earlier group's waves on the scheduler's prep stream; every answer
     equals the host PrePost miner's. Then a request past its deadline
     (``DeadlineExceeded``, no launch), a burst past ``max_queue_depth=1``
     (``Overloaded``), a chaos-crashed batch followed by one that serves, a
     second service warm-starting the kosarak sweep from the first one's
     snapshots (0 prepares), a trace and a stats emitter. Last, the same
     load with overlap on and off (on, off, off, on; unprofiled, then under
     torch.profiler): batch walls, the ``scheduler.prep_wait_s`` p50, the
     device idle share and whether device work on the prep stream and on
     the wave stream ran at the same time.
  8. streaming and continuous mining (``MiningEngine(device="cuda").append``
     / ``submit_stream`` / ``register_standing`` and the service's stream
     lane), on the full-scale datasets: 8a mushroom streamed as 4 and as 16
     batches — each append prepares its batch alone (one B4 launch, no B3,
     ``prep_source == "built"``) and the sweep 0.3/0.2/0.15 from the live
     stream equals a one-shot mine and the host PrePost miner, the queries
     launching B1 once per segment per wave and B2 never; 8b pumsb as 4
     batches at its full width (``max_f1=8192``: B4 at K = 7,117), its
     query at 0.15 equal to the one-shot mine and the host PrePost miner,
     with each segment's sizes and B4 and B1 held to their plain versions at
     the segment's shapes; 8c each append of the 16-batch stream timed
     against a one-shot prepare of all rows so far, a query at 4 and at 16
     segments against a warm monolithic mine, and compaction; 8d a
     4-batch sliding window (equal to a one-shot mine over the window's
     rows) with a standing query whose diffs replay to the final answer,
     and a decayed stream against ``damped_oracle``; 8e a second engine
     replaying 8a's append log from snapshots (no prepare, no B4), then
     appends, stream queries and a standing query through one
     ``MiningService`` from two producer threads, and an async compaction
     racing a served query.
  9. HPrepost on a mesh (``MiningEngine(mesh=make_mesh(shape, axes,
     devices=[cuda:0] * n), prep_cache_bytes=0)``): mushroom@0.15,
     pumsb@0.15 and kosarak@0.01 at full scale on (2, 1), (4, 1) and (4, 2)
     with locality dispatch, on (2, 2) with the shuffle (through
     ``HPrepostMiner``: ``MineSpec`` has no locality knob) and on (1, 2)
     (early stop, B2 per candidate group). Every answer equals the host
     PrePost miner's and phase 4's 1×1 answer; each prepare launches B3 and
     B4 once per data shard, each wave one wave kernel per position (B1
     when D > 1, B2 on (1, 2)); the card's D-shard ``to_host()`` payload
     equals a CPU mesh's on mushroom (every D) and pumsb (D = 2, 4). Then
     a (2, 1) snapshot warm-starting a (2, 2) engine with no prepare and a
     (1, 1) engine rebuilding, one (2, 2) ``MiningService`` batch, and a
     4-batch mushroom stream on (2, 1). Each mine prints its wall, the
     per-shard packed bytes and tree nodes (the paper's per-reducer
     memory), peak device memory, launches and the number of distinct cards
     (every position shares one card here, so nothing of an interconnect
     is measured); last, each dataset warm on (1, 1) and (4, 2) under
     torch.profiler (device busy time and idle share).
 10. HPrepost's JobTracker and TaskTrackers as live processes
     (``MiningEngine(device="cuda", snapshot_dir=tmp).distribute(workers=2)``:
     a coordinator that plans every wave on the host, and two spawned
     worker processes, each with its own CUDA context on ``cuda:0``):
     10a mushroom appended as 4 batches, each built on one worker (B4 once
     per segment in that worker, no B3), placed over both workers; the
     sweep 0.3/0.2/0.15 equal to the host PrePost miner, phase 8a's
     4-batch stream and phase 4's one-shot answer, the workers' B1
     launches = waves × segments and B2 none; 10b pumsb as 4 batches at
     its full width (``max_f1=8192``), its query at 0.15 equal to the host
     miner's, with each append's reply bytes (the segment's C block over
     loopback) and walls; 10c the lower worker killed (the sweep unchanged,
     every re-placed segment restored from snapshots), then a second
     database with ``restart_budget=1`` whose worker dies one wave into a
     query (``inject_fault``): the query replays bit-identically and the
     worker is respawned; 10d ``MiningService(engine=...)`` stream Futures
     against it, ``stats()["counters"]["respawns"]`` reading the
     coordinator's; 10e spawn-to-hello per worker, append and query walls
     (against 8a's single-process query), each worker's ``wave_rpc_s``
     p50 and device memory. The workers' launch counters are read through
     ``worker_stats()`` before a worker is killed or closed; every worker
     is closed and none outlives the phase.
 11. the LM scaffold's serving path (``repro_torch.serving.Engine``; no
     kernel of this repo runs there, so no counter moves): 11a every arch
     of ``configs.ARCH_IDS`` at full width in its config dtype (bfloat16
     compute over float32 parameters from a seeded ``torch.Generator``),
     whole, except internlm2_20b, internvl2_26b and phi3_5_moe, cut to 2
     layers (their float32 parameters pass 40 GB): ``Engine(batch_size=4,
     max_seq=128)`` serves ``launch.serve``'s request set twice (every
     token in ``[0, padded_vocab)``, the same tokens both times), then the
     decode step against a full prefill at the family's fewest layers, in
     float32 (the reference's ``allclose(2e-3)``) and bfloat16 (within
     0.25 of the largest |logit|; see ``lm_consistency``), each arch
     printing its peak memory and freed before the next; 11b tinyllama,
     granite_moe, zamba2 and seamless at full width and fewest layers in
     float32, one set of weights on the card and on the CPU (TF32 off):
     prefill and 4 decode steps within 1e-3 of the logits' scale, the same
     greedy tokens; 11c tinyllama's full config: prefill of the batch,
     decode ms a step (median after warm-up), tokens/s, peak memory and the
     decode step's bound (parameter bytes + KV-cache bytes over 3.35 TB/s),
     and 8 decode steps under torch.profiler. The phase stays within 120 s.
 12. the LM scaffold's training path (``repro_torch.training``; no kernel
     of this repo runs there: every counter is 0 after it): 12a
     tinyllama_1_1b's full config (float32 parameters and moments,
     bfloat16 compute), ``make_train_state`` on the card and the Trainer's
     ``make_train_step``, batch 8 × seq 128 from ``corpus.batches``, 2
     warm-up and 6 timed steps (median step ms, tokens/s, peak memory,
     finite losses, parameters moved), 3 steps with the deterministic
     context off (its cost), 2 steps split into loss-and-gradients and
     AdamW, one step under torch.profiler (device ops, busy ms, idle share
     against the unprofiled median step, device time by op) and the step's
     bound; no checkpoint (13.2 GB a save); 12b ``launch.train.main`` on the reduced config, 24 steps
     with a checkpoint every 8 and a failure injected at step 13, against an
     uninterrupted run: the final checkpoints' parameters equal bit for bit;
     12c every arch at full width and ``lm_fewest_layers``, one set of
     float32 weights drawn on the CPU: the loss and every gradient leaf of
     one batch (2 × 24 tokens) on the card and on the CPU within
     LM_TRAIN_TOL of the scale (the xLSTM also each side against a
     float64 evaluation on the card, within LM_TRAIN_F64_TOL, with its five
     worst leaves, the float64 evaluation on the CPU, the recompute off and
     its sLSTM or mLSTM blocks alone in float64: ``lm_train_f64_gaps``),
     then one ``make_train_step`` in the config's dtype on the card (finite
     loss and grad norm). The phase stays within 180 s.
 13. the LM scaffold's training over a mesh (``repro_torch.sharding``,
     ``make_train_step(..., rules)``; no kernel of this repo runs there):
     13a tinyllama_1_1b's full config with the launcher's defaults on
     ``make_mesh_from_spec("8x1", [cuda:0] * 8)``, 3 ZeRO-1 steps against 3
     one-device steps from the same seed and batches, loss, grad norm, p, m
     and v equal bit for bit after each (median ms of each, peak memory with
     both states resident, the moments' split bytes and blocks); then the
     reduced config trained on 8x1, checkpointed at step 2, restored onto
     2x1 and onto no mesh and run on, equal to the uninterrupted run bit for
     bit; 13b ``moe_ffn(..., mesh=)`` (``_moe_sharded``) for granite_moe's
     full-width MoE in float32, batch (4, 128), on (1, 1), (2, 1), (1, 2)
     and (2, 2) at capacity factors 1.25 and 4.0, card against CPU within
     LM_MESH_TOL of the scale (ms of each); 13c ``gpipe_forward`` over
     tinyllama's 22 decoder blocks in float32, 2 stages, 4 microbatches of
     2 × 128, against the sequential run within LM_MESH_TOL (ms of both);
     13d ``compressed_psum`` card against CPU bit for bit, on 4 shards of
     tinyllama's ``wq`` shape and on shards whose scales differ. The phase
     stays within 120 s.
 14. the dry-run tooling (``repro_torch.launch.{cost,roofline,dryrun,
     dryrun_fim}``): 14a ``dryrun_fim.run`` at the reference's production
     scale (R = 1,048,576 × 48 Zipf rows over 41,270 items, K = 2,048,
     W = 512, C = 8,192) on ``1x1`` and on ``2x2`` with every position on
     ``cuda:0``: each stage's outputs equal to the same stage run with the
     plain kernel versions on the card, exactly (B3 in job1, B4 in f2, B2 in
     the 1x1 shuffle wave, B1 in the other waves; job2 runs no kernel and is
     run twice), each stage's median ms, roofline terms, ratio and peak
     memory printed; then B3, B4, B2 and B1 timed alone at those shapes
     against their plain versions and their cost functions' bounds (and
     B3's, B4's library calls); 14b ``dryrun.main(["--all", "--mesh",
     "16x16", ...])`` on the host (meta, 8 processes): no cell in error, the
     compiled and skipped cells as ``registry.applicable`` says (32 and 8),
     one line a cell. The phase stays within 150 s.
 15. the rows' copy (``h2d_phase``): kosarak's 990,002 x 48 int32 rows
     (190 MB, pageable) to the card four ways, median ms and GB/s of each:
     the pageable ``.to()`` the miner took before its staging ring, the
     ring (``StagingRing.copy`` into a preallocated block, and
     ``HPrepostMiner._shard_rows`` whole), the ring's host fills alone
     (no DMA) and the pinned DMA alone (one 190 MB pinned buffer; the
     ring's chunks from pinned slots, no fill), each copy after an untimed
     one-shot mine; every staged block equal to the pageable one bit for
     bit; then the sweep over slot bytes, slots and fillers that fixed
     ``repro_torch.device``'s constants, with
     ``torch.get_num_threads()``, the CPUs the process may use, and the
     card and its power limit.
Then one JSON line describing the kernels (launches: phases 4, 6, 7, 8, 9,
10 and 14), and last the device line.

It needs a CUDA device and the repository's ``src/`` beside it; without
either it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

MB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2, queued: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events).

    ``queued``: the stream is held by a sleep kernel while the host enqueues
    the launches, so they run back to back and the events time the device
    alone, not the host's launch overhead. ``queued=False`` is the earlier
    method (events around launches issued as the host gets to them), kept
    so that numbers taken that way can be compared like for like."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(1_000_000 * reps)  # ~0.6 ms a launch at 1.7 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def assert_equal(name: str, got, want) -> int:
    """Exact equality of integer outputs; returns the max abs error (0)."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}")
        err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        if err:
            raise AssertionError(f"{name}: max abs error {err} against the plain version")
    return 0


def hist_cases(dev):
    """B3's cases beyond the main path, on the card: (label, rows, weights,
    n_bins). Rows of 47 slots with PAD anywhere, a repeated item in every
    row and ids at or past n_bins; weights 0, negative and large enough to
    wrap int32."""
    gen = torch.Generator(device=dev).manual_seed(13)
    R, L, n_bins = 200_000, 47, 41_270
    rows = torch.randint(0, n_bins, (R, L), generator=gen, device=dev, dtype=torch.int32)
    rows[:, 5] = rows[:, 3]
    rows[torch.rand((R, L), generator=gen, device=dev) < 0.5] = -1
    far = torch.rand((R, L), generator=gen, device=dev) < 0.01
    rows[far] = n_bins + torch.randint(0, 1 << 20, (int(far.sum()),), generator=gen, device=dev,
                                       dtype=torch.int32)
    pick = torch.tensor([0, 1, -1, -7, 3, 1 << 30, 2**31 - 1, -2**31], dtype=torch.int32, device=dev)
    w = pick[torch.randint(0, len(pick), (R,), generator=gen, device=dev)]
    small = torch.randint(-1, 500, (100_003, 3), generator=gen, device=dev, dtype=torch.int32)
    ws = torch.randint(-3, 4, (100_003,), generator=gen, device=dev, dtype=torch.int32)
    return [
        ("weights 0, negative and wrapping; repeated items; PAD mid-row; ids >= n_bins", rows, w, n_bins),
        ("a misaligned view rows[1:] (L = 47) and weights[1:]", rows[1:], w[1:], n_bins),
        ("70,000 bins (bins in global memory)", rows, w, 70_000),
        ("70,000 bins, misaligned view rows[3:]", rows[3:], w[3:], 70_000),
        ("7,117 bins (pumsb's universe), weighted", rows, w, 7_117),
        ("L = 3, 500 bins (tiles span more rows than a stage holds weights for)", small, ws, 500),
        ("L = 3, misaligned view rows[1:]", small[1:], ws[1:], 500),
    ]


def level2_wave(miner, prep, min_count):
    """The main path's first wave on ``prep``: every frequent pair, laid out
    as ``HPrepostMiner.mine_prepared`` does — the (3, K, W) planes, the
    singleton states and the wave's (3, Cpad) index rows, which the fused
    wave kernel reads in place."""
    qs, ps = np.nonzero(prep.C >= min_count)
    ranks = np.stack([qs, ps], axis=1).astype(np.int32)
    idx, _, _ = miner._pack_wave(ranks, ps.astype(np.int64), qs.astype(np.int32))
    planes = prep.packed[0].permute(2, 0, 1).contiguous()
    return planes, planes[2], torch.from_numpy(idx).cuda(), len(ranks)


def fim_wave(dev, C: int = 1024):
    """A wave of C candidates on Job 2's real N-lists at the reference's
    production scale, as ``launch.dryrun_fim`` builds it (1,048,576 × 48
    Zipf rows, K = 2,048, W = 512; C cut from 8,192): -> (planes (3, K, W),
    the parents' state (C, W) drawn below each code's count, the shuffle
    wave's (3, C) index rows, C, its early-stop threshold)."""
    from repro_torch.launch import dryrun_fim

    outputs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        dryrun_fim.run(None, "1x1", C=C, device=dev, out_dir=out_dir, reps=1, outputs=outputs)
    inp = outputs["inputs"]
    return (torch.from_numpy(inp["planes"][0]).to(dev), torch.from_numpy(inp["state"][0]).to(dev),
            torch.from_numpy(np.ascontiguousarray(inp["idx_shuffle"])).to(dev), inp["C"], inp["stop"])


def padding_contract(K, nl_ref, label, planes, state, idx, n_live, stops, gen) -> int:
    """B1 and B2 through the wave entry, held to their plain versions (max
    abs error 0) on one wave's real N-lists with soiled padding slots (pre
    INT32_MAX). Parent states: the in-contract one, 0-4 on every slot, each
    code's count + 1, and the in-contract one with counts on padding slots
    only; each with the clean planes and with planes whose padding slots
    carry posts and counts (A's counts weigh in B2's liveness mass). Under
    the padding contract the in-contract state and the padding-only one
    give the in-contract answer with either planes. B1, and B2 at ``stops``
    x la_block 128, 256 and 512, each at ``n_live`` candidates (>= 4 a SM:
    256-thread blocks) and at 2 a SM (1,024-thread blocks), so every
    instantiation the launcher picks at this width runs. -> comparisons."""
    INF = torch.iinfo(torch.int32).max
    sms = torch.cuda.get_device_properties(planes.device).multi_processor_count
    few = 2 * sms
    if not n_live >= 4 * sms > few:
        raise AssertionError(f"{label}: {n_live} candidates do not reach 4 a SM ({4 * sms})")
    live = idx[:, :n_live]
    row_pre = torch.full_like(state, INF)  # a state row lies on its base item's code slots
    row_pre[live[0]] = planes[0][live[1]]
    row_cnt = torch.zeros_like(state)
    row_cnt[live[0]] = planes[2][live[1]]

    def draw(lo, hi, like):
        return torch.randint(lo, hi, like.shape, generator=gen, device=like.device, dtype=torch.int32)

    states = {
        "in-contract state": state,
        "0-4 on every slot": draw(0, 5, state),
        "each code's count + 1": row_cnt + 1,
        "counts on padding only": torch.where(row_pre == INF, draw(1, 1000, state), state),
    }
    soiled = planes.clone()
    pad = planes[0] == INF
    soiled[1] = torch.where(pad, draw(-1, 16, pad), planes[1])
    soiled[2] = torch.where(pad, draw(1, 1000, pad), planes[2])
    kws = [{}] + [dict(early_stop=True, min_count=s, la_block=lab) for s in stops for lab in (128, 256, 512)]
    n = 0
    for nl in (n_live, few):
        for kw in kws:
            contract = nl_ref.nlist_wave_ref(planes, state, idx, nl, **kw)
            for sname, st in states.items():
                for pname, pl in (("clean planes", planes), ("soiled planes", soiled)):
                    what = (f"{'nlist_intersect_es' if kw else 'nlist_intersect'} {label}: {sname}, "
                            f"{pname}, n_live {nl}{', ' + str(kw) if kw else ''}")
                    got = K.nlist_wave_cuda(pl, st, idx, nl, **kw)
                    assert_equal(what, got, nl_ref.nlist_wave_ref(pl, st, idx, nl, **kw))
                    if sname in ("in-contract state", "counts on padding only"):
                        assert_equal(what + ", against the in-contract answer", got, contract)
                    n += 1
    return n


def cooccur_library(ranked, w, k, want, timing=None, reps: int = 10) -> dict:
    """B4's yardstick: PyTorch calls that compute its function,
    C = X^T diag(w) X with X[r, i] the count of item i in row r, on the same
    inputs (X built outside the timing), each held equal to the kernel's
    ``want`` (exact while every sum stays below 2^24). ``library_ms`` is
    the weighted fp32 product; where every weight is 1, on the card, the
    exact tensor-core forms are timed beside it: a bf16 one-hot with fp32
    accumulation, and ``torch._int_mm`` on an int8 one-hot with int32
    accumulation (rows and items padded with zeros to multiples of 8)."""
    timing = timing or time_ms
    R = ranked.shape[0]
    X = torch.zeros((R, k + 1), dtype=torch.float32, device=ranked.device)
    X.scatter_add_(1, torch.where(ranked >= 0, ranked, k).long(), torch.ones_like(ranked, dtype=torch.float32))
    X = X[:, :k].contiguous()
    wf = w.to(torch.float32)[:, None]

    def fp32():
        return (X * wf).T @ X

    assert_equal("cooccur library fp32", (fp32().to(torch.int32),), (want,))
    out = dict(library_ms=timing(fp32, reps=reps),
               library_call="weighted one-hot fp32 matmul (X * w[:, None]).T @ X (one-hot built outside the timing)")
    if not (X.is_cuda and bool((w == 1).all())):
        return out
    Xb = X.to(torch.bfloat16)
    del X

    def bf16():
        return torch.mm(Xb.T, Xb, out_dtype=torch.float32)

    assert_equal("cooccur library bf16", (bf16().to(torch.int32),), (want,))
    out["bf16_ms"] = timing(bf16, reps=reps)
    k8, R8 = -(-k // 8) * 8, -(-R // 8) * 8
    X8t = torch.zeros((k8, R8), dtype=torch.int8, device=ranked.device)  # row-major X^T
    X8t[:k, :R] = Xb.T
    del Xb

    def int8():
        return torch._int_mm(X8t, X8t.T)  # (k8, R8) row-major by (R8, k8) column-major

    assert_equal("cooccur library int8", (int8()[:k, :k],), (want,))
    out["int8_ms"] = timing(int8, reps=reps)
    out["tensor_core_calls"] = ("bf16_ms: torch.mm(Xb.T, Xb, out_dtype=float32) on a bf16 one-hot; int8_ms: "
                                "torch._int_mm on an int8 one-hot (int32 sums); both exact below 2^24")
    return out


PEAK_INT8_OPS = 1979e12  # the H100 SXM's dense int8 tensor-core rate (NVIDIA's data sheet)


def ptxas_report(name: str) -> list[dict]:
    """Each kernel instance of ``csrc/<name>.cu`` as ptxas reported it in
    this run's build (``-Xptxas -v``): registers, spill bytes, static
    shared memory."""
    from repro_torch.kernels import _cuda

    out, cur = [], None
    for line in _cuda.build_logs.get(name, "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            m = re.search(r"([a-z_]+_kernel)(ILi(\d+)E)?", fn)  # the mangled name, shortened
            cur = dict(function=(m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")) if m else fn)
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
            cur["spill_stores"], cur["spill_loads"] = nums[1], nums[2]
        elif cur is not None and "registers" in line:
            words = line.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            cur["static_smem"] = int(words[words.index("smem") - 2]) if "smem" in words else 0
    return out


def cooccur_extras(ranked, w, k: int, timing=None) -> dict:
    """B4's design numbers at one shape, for the log line: the bucketing
    pass alone (K > 128; not a counted launch), the dense-product floor (the
    upper triangle's R x k(k+1)/2 multiply-adds at the int8 peak: what a
    dense one-hot product could not beat), the scratch and the instances'
    dynamic shared memory. Of these only ``bucket_ms`` is measured, so only
    it goes into the ``kernels`` line (``measured_extras``)."""
    from repro_torch.kernels.cooccur import kernel as kk

    timing = timing or time_ms
    R, L = ranked.shape
    macs = R * k * (k + 1) // 2
    e = dict(dense_floor_ms=2 * macs / PEAK_INT8_OPS * 1e3, dense_macs=macs)
    if k <= kk.BAND:
        e.update(instance=f"cooc_band_kernel<{64 if k <= 64 else 128}>", scratch_bytes=0)
        return e
    lib = kk._library()
    blocks = kk.product_blocks(R, k, torch.cuda.get_device_properties(ranked.device).multi_processor_count)
    e.update(instance="cooc_bucket_kernel + cooc_wgmma_kernel", product_blocks=blocks,
             scratch_bytes=lib.cooccur_scratch_bytes(R, L, k, blocks),
             dynamic_smem={"cooc_bucket_kernel": lib.cooccur_smem_bytes(k, L, 0),
                           "cooc_wgmma_kernel": lib.cooccur_smem_bytes(k, L, 1)},
             bucket_ms=timing(lambda: kk.cooccur_bucket_pass(ranked, w, n_items=k)))
    return e


def measured_extras(e: dict) -> dict:
    """The measured part of ``cooccur_extras``: the bucketing pass's time."""
    return {"bucket_ms": e["bucket_ms"]} if "bucket_ms" in e else {}


def log_cooccur_extras(label: str, e: dict, smi: str) -> None:
    bucket = f"bucketing pass alone {e['bucket_ms']:.4f} ms, " if "bucket_ms" in e else ""
    log(f"  B4 design at {label}: {e['instance']}; {bucket}dense-product floor {e['dense_floor_ms']:.4f} ms "
        f"({e['dense_macs']} multiply-adds at 1,979 TOPS); scratch {e['scratch_bytes']} bytes"
        + (f"; dynamic shared memory {json.dumps(e['dynamic_smem'])}" if "dynamic_smem" in e else "")
        + f"; ptxas {json.dumps(ptxas_report('cooccur'))} [{smi}]")


def host_answer(data, host, name, min_count):
    """The host PrePost miner's itemsets for (dataset, min_count), memoized
    in ``host``."""
    from repro_torch.core.prepost import mine_prepost

    if (name, min_count) not in host:
        rows, n_items = data[name]
        host[name, min_count] = mine_prepost(rows, n_items, min_count).itemsets
    return host[name, min_count]


def engine_phase(K, data, host) -> dict[str, int]:
    """Phase 6: the resident ``MiningEngine`` on the card (see the module
    docstring). ``host`` maps (dataset, min_count) to the host PrePost
    miner's itemsets, filled by phase 4 and here. -> this phase's launches."""
    from repro_torch.mining import MineSpec, MiningEngine

    def check_host(what, name, results):
        for r in results:
            want = host_answer(data, host, name, r.min_count)
            if r.itemsets != want:
                raise AssertionError(f"{what} at min_count {r.min_count}: {len(r.itemsets)} itemsets "
                                     f"vs {len(want)} from the host PrePost miner")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def moved_since(before):
        return {k: v - before[k] for k, v in K.launches().items()}

    K.reset_launches()
    spec = MineSpec(algorithm="hprepost")
    sweeps = {"mushroom": [0.3, 0.2, 0.15], "kosarak": [0.02, 0.01]}

    # 6a. planned sweeps: one prepare per dataset at the loosest threshold
    eng = MiningEngine(device="cuda")
    oneshot = MiningEngine(device="cuda", prep_cache_bytes=0)
    prep_bytes = {}  # dataset -> its cached PreparedDB's prep_bytes
    for name, fracs in sweeps.items():
        rows, n_items = data[name]
        _, fp_s = timed(lambda: MiningEngine._digest(rows))  # what a new engine hashes first
        log(f"engine fingerprint {name}: sha1 of {rows.nbytes} bytes of rows on the host {fp_s:.4f}s")
        for es in ((True, False) if name == "mushroom" else (True,)):
            sp = spec.with_(early_stop=es)
            kname = "nlist_intersect_es" if es else "nlist_intersect"
            miner = eng.frontend("hprepost").miner_for(sp)  # the resident miner the sweep uses
            waves0, before, p0 = miner.stage_counters["waves"], K.launches(), eng.stats["prepares"]
            in_use = eng.cache_info()["bytes_in_use"]
            results, wall = timed(lambda: eng.sweep(rows, n_items, sp, fracs))
            moved = moved_since(before)
            prepares = eng.stats["prepares"] - p0
            waves = miner.stage_counters["waves"] - waves0
            prep_bytes.setdefault(name, eng.cache_info()["bytes_in_use"] - in_use)
            want_prepares = 1 if es else 0  # early stop is execution-only: the prep is cached
            if prepares != want_prepares or not (moved["histogram"] == moved["cooccur"] == prepares):
                raise AssertionError(f"sweep {name} early_stop={es}: {prepares} prepares, launches {moved}")
            if moved[kname] != waves or not all(r.stage_times_s["planned_candidates"] > 0
                                                for r in results):
                raise AssertionError(f"sweep {name} early_stop={es}: {kname} launched {moved[kname]} "
                                     f"times for {waves} waves, or a threshold ran no wave")
            check_host(f"sweep {name} early_stop={es}", name, results)
            singles = [timed(lambda f=f: oneshot.submit(rows, n_items, sp.with_(min_sup=f)))[1]
                       for f in fracs]
            log(f"engine sweep {name}@{fracs} early_stop={es}: wall {wall:.4f}s against "
                f"{sum(singles):.4f}s for one-shot mines ({', '.join(f'{t:.4f}' for t in singles)}); "
                f"{prepares} prepare(s), launches {json.dumps(moved)}, "
                f"prep sources {[r.service_stats['prep_source'] for r in results]}, "
                f"itemsets {[len(r.itemsets) for r in results]} == host mine_prepost")
    del eng, oneshot

    # 6b. snapshot warm start: a fresh engine on the same store prepares nothing
    rows, n_items = data["kosarak"]
    with tempfile.TemporaryDirectory() as snap:
        cold = MiningEngine(device="cuda", snapshot_dir=snap)
        cold_res, cold_wall = timed(lambda: cold.sweep(rows, n_items, spec, sweeps["kosarak"]))
        before = K.launches()
        warm = MiningEngine(device="cuda", snapshot_dir=snap)
        warm_res, warm_wall = timed(lambda: warm.sweep(rows, n_items, spec, sweeps["kosarak"]))
        moved = moved_since(before)
        info = warm.cache_info()
        if (warm.stats["prepares"] != 0 or info["snapshot_hits"] < 1 or moved["histogram"]
                or moved["cooccur"]
                or any(r.service_stats["prep_source"] != "snapshot" for r in warm_res)):
            raise AssertionError(f"snapshot warm start: stats {warm.stats}, cache {info}, "
                                 f"launches {moved}")
        if [r.itemsets for r in warm_res] != [r.itemsets for r in cold_res]:
            raise AssertionError("snapshot warm start: itemsets differ from the cold sweep")
        check_host("snapshot warm start", "kosarak", warm_res)
        prep = cold.telemetry.histogram("engine.prep_s").snapshot()["sum_s"]
        hit = warm.telemetry.histogram("engine.snapshot_hit_s").snapshot()["sum_s"]
        log(f"engine snapshot kosarak@{sweeps['kosarak']}: cold sweep {cold_wall:.4f}s with prep "
            f"{prep:.4f}s; fresh engine on the store {warm_wall:.4f}s with warm start (store read + "
            f"host-to-device) {hit:.4f}s; 0 prepares, launches {json.dumps(moved)}, "
            f"{info['snapshot_store']['bytes_in_use']} bytes on disk")
        del cold, warm

    # 6c. the kernel tuner: cold search, then a fresh engine with zero trials
    rows, n_items = data["mushroom"]
    tspec = spec.with_(min_sup=0.15, tune=True)
    with tempfile.TemporaryDirectory() as snap:
        e1 = MiningEngine(device="cuda", snapshot_dir=snap)
        search_s = []
        search = e1.tuner._search

        def timed_search(*a):
            t0 = time.perf_counter()
            out = search(*a)
            search_s.append(time.perf_counter() - t0)
            return out

        e1.tuner._search = timed_search
        r1, wall1 = timed(lambda: e1.submit(rows, n_items, tspec))
        st1 = dict(e1.tuner.stats)
        with open(Path(snap) / "kernel_plans.json") as f:
            plans = json.load(f)["plans"]
        e2 = MiningEngine(device="cuda", snapshot_dir=snap)
        r2, wall2 = timed(lambda: e2.submit(rows, n_items, tspec))
        st2 = dict(e2.tuner.stats)
        if st1["trials"] <= 0 or st1["tuned"] <= 0 or st2["trials"] != 0 or st2["plan_hits"] <= 0:
            raise AssertionError(f"tuner: cold stats {st1}, warm stats {st2}")
        check_host("tuned mine", "mushroom", [r1, r2])
        log(f"engine tuner mushroom@0.15: cold {json.dumps(st1)}, search {sum(search_s):.4f}s over "
            f"{len(search_s)} key(s), mine wall {wall1:.4f}s; warm {json.dumps(st2)}, wall "
            f"{wall2:.4f}s; plans {json.dumps(plans)}")
        del e1, e2

    # 6d. LRU eviction returns the evicted prep's device memory
    gc.collect()
    base = torch.cuda.memory_allocated()
    ref = MiningEngine(device="cuda")
    ref.submit(data["kosarak"][0], data["kosarak"][1], spec.with_(min_sup=0.01))
    only_kosarak = torch.cuda.memory_allocated()
    del ref
    gc.collect()
    budget = prep_bytes["kosarak"] + prep_bytes["mushroom"] // 2  # fits kosarak's prep, not both
    lru = MiningEngine(device="cuda", prep_cache_bytes=budget)
    lru.submit(*data["mushroom"], spec.with_(min_sup=0.15))
    with_mushroom = torch.cuda.memory_allocated()
    lru.submit(*data["kosarak"], spec.with_(min_sup=0.01))  # evicts mushroom's prep
    gc.collect()
    after = torch.cuda.memory_allocated()
    info = lru.cache_info()
    if info["evictions"] != 1 or info["entries"] != 1 or abs(after - only_kosarak) > MB:
        raise AssertionError(f"LRU eviction: cache {info}, {after} bytes allocated against "
                             f"{only_kosarak} with only kosarak's prep resident")
    log(f"engine LRU: budget {budget} bytes (preps: mushroom {prep_bytes['mushroom']}, kosarak "
        f"{prep_bytes['kosarak']}); allocated {base} bytes before, {with_mushroom} with mushroom's prep, "
        f"{after} after kosarak's insert evicted it, {only_kosarak} with only kosarak's; "
        f"evictions {info['evictions']}")
    del lru
    gc.collect()
    got = K.launches()
    if not all(got.values()):
        raise AssertionError(f"a kernel was not launched in phase 6: {got}")
    return got


# the load phase 7 serves: one list per producer thread of (dataset, min_sup,
# algorithm); three device groups on distinct databases and one host request
SERVICE_LOAD = [
    [("mushroom", 0.3, "hprepost"), ("mushroom", 0.2, "hprepost"), ("mushroom", 0.15, "hprepost"),
     ("mushroom", 0.3, "apriori")],
    [("pumsb", 0.15, "hprepost")],
    [("kosarak", 0.02, "hprepost"), ("kosarak", 0.01, "hprepost")],
]


def serve_load(svc, data):
    """Submit ``SERVICE_LOAD`` from three producer threads inside one batch
    window and wait for every answer. The threads are released together
    and each makes its first submit after the previous thread's, so the
    groups arrive, and are served, in the load's order: the small preps
    first, kosarak's last, behind waves it can hide under. -> ([(dataset,
    algorithm, MineResult)] in load order, wall seconds from the release to
    the last answer)."""
    from repro_torch.mining import MineSpec

    spec = MineSpec(algorithm="hprepost")
    start = threading.Barrier(len(SERVICE_LOAD) + 1)
    turn = [threading.Event() for _ in range(len(SERVICE_LOAD) + 1)]
    turn[0].set()
    futs = [[None] * len(p) for p in SERVICE_LOAD]
    errors = []

    def producer(i):
        start.wait()
        try:
            turn[i].wait(10)
            for j, (name, frac, algo) in enumerate(SERVICE_LOAD[i]):
                rows, n_items = data[name]
                futs[i][j] = svc.submit(rows, n_items, spec.with_(algorithm=algo, min_sup=frac))
                turn[i + 1].set()
        except BaseException as e:  # surfaced below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(i,)) for i in range(len(SERVICE_LOAD))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(60)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"a producer failed or hung: {errors}")
    out = [(name, algo, f.result(timeout=600))
           for plan, fs in zip(SERVICE_LOAD, futs) for (name, _, algo), f in zip(plan, fs)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def union_us(spans) -> list[tuple[float, float]]:
    """Merge (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_timeline(prof) -> dict:
    """From a torch.profiler run: device busy ms (the union of kernel, copy
    and memset intervals) and, when prep (B3/B4) and waves (B1/B2) ran on
    different streams, the ms in which the two streams both had device
    work. Read from the profiler's Chrome trace, whose device events carry
    their stream."""
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    ivs = [(e["name"], (e.get("args") or {}).get("stream", e.get("tid")), float(e["ts"]),
            float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(b - a for a, b in union_us([(a, b) for _, _, a, b in ivs])) / 1e3
    prep = {s for n, s, _, _ in ivs if "hist_kernel" in n or "cooc_" in n}
    wave = {s for n, s, _, _ in ivs if "wave_kernel" in n}
    out = {"busy_ms": busy, "device_events": len(ivs), "prep_streams": sorted(map(str, prep)),
           "wave_streams": sorted(map(str, wave)), "concurrent_ms": None}
    if prep and wave and not prep & wave:
        up = union_us([(a, b) for _, s, a, b in ivs if s in prep])
        uw = union_us([(a, b) for _, s, a, b in ivs if s in wave])
        both, i, j = 0.0, 0, 0
        while i < len(up) and j < len(uw):
            lo, hi = max(up[i][0], uw[j][0]), min(up[i][1], uw[j][1])
            both += max(0.0, hi - lo)
            if up[i][1] < uw[j][1]:
                i += 1
            else:
                j += 1
        out["concurrent_ms"] = both / 1e3
    return out


def service_phase(K, data, host) -> dict[str, int]:
    """Phase 7: the resident ``MiningService`` on the card (see the module
    docstring). -> this phase's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fault import failures
    from repro_torch.mining import MineSpec, MiningEngine, MiningService
    from repro_torch.mining.service import DeadlineExceeded, Overloaded
    from repro_torch.mining.telemetry import Registry, StatsEmitter, TraceRecorder, trace

    spec = MineSpec(algorithm="hprepost")
    n_groups = len(SERVICE_LOAD)

    def moved_since(before):
        return {k: v - before[k] for k, v in K.launches().items()}

    def check_host(what, results):
        for name, algo, r in results:
            want = host_answer(data, host, name, r.min_count)
            if r.itemsets != want:
                raise AssertionError(f"{what}: {algo} {name} at min_count {r.min_count}: "
                                     f"{len(r.itemsets)} itemsets vs {len(want)} from the host PrePost miner")

    def waves(svc):
        return svc.engine.frontend("hprepost").miner_for(spec).stage_counters["waves"]

    def counts(svc):
        """The counters one batch moves: service, engine and scheduler."""
        return {"batches": svc.stats["batches"], "requests": svc.stats["requests"],
                "prepares": svc.engine.stats["prepares"], "waves": waves(svc),
                **{k: svc.scheduler.stats[k] for k in ("device_groups", "host_requests",
                                                       "overlapped_prepares")}}

    def check_batch(what, svc, results, c0, moved, overlap=True):
        """One batch of the load: all of it in one batch, three groups each
        prepared once (B3 and B4 once a group, B2 on every wave, B1 never),
        every group after the first prepared ahead when overlapping, every
        prep built, every answer the host's. -> the counters' deltas."""
        d = {k: v - c0[k] for k, v in counts(svc).items()}
        want = {"batches": 1, "requests": sum(map(len, SERVICE_LOAD)), "prepares": n_groups,
                "waves": d["waves"], "device_groups": n_groups, "host_requests": 1,
                "overlapped_prepares": n_groups - 1 if overlap else 0}
        if d != want:
            raise AssertionError(f"{what}: counters moved {d}, expected {want}")
        if (moved["histogram"] != n_groups or moved["cooccur"] != n_groups
                or moved["nlist_intersect_es"] != d["waves"] or moved["nlist_intersect"]):
            raise AssertionError(f"{what}: launches {moved} for {n_groups} groups and {d['waves']} waves")
        sources = [r.service_stats.get("prep_source") for _, algo, r in results if algo == "hprepost"]
        if sources != ["built"] * len(sources):
            raise AssertionError(f"{what}: prep sources {sources}")
        check_host(what, results)
        return d

    K.reset_launches()
    with tempfile.TemporaryDirectory() as snap:
        # 7a. the load on a fresh service, traced, with a stats emitter
        rec, sink = TraceRecorder(), io.StringIO()
        svc = MiningService(device="cuda", snapshot_dir=snap, batch_window_s=0.05)
        emitter = StatsEmitter(svc.stats, sink, interval_s=0.05).start()
        before, c0 = K.launches(), counts(svc)
        with trace.attached(rec):
            results, wall = serve_load(svc, data)
        moved = moved_since(before)
        check_batch("service batch", svc, results, c0, moved)
        sch = dict(svc.scheduler.stats)
        spans = {}
        for ev in rec.to_chrome():
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
        log(f"service batch (7 requests from 3 threads, 1 batch): wall {wall:.4f}s; "
            f"group.classify (fingerprints) {sum(spans['group.classify']):.1f}ms, "
            f"group.prep waits {[round(x, 1) for x in spans['group.prep']]}ms, "
            f"group.serve {[round(x, 1) for x in spans['group.serve']]}ms; scheduler {json.dumps(sch)}; "
            f"launches {json.dumps(moved)}; prep sources "
            f"{[(n, r.service_stats.get('prep_source'), r.service_stats.get('prep_overlapped')) for n, _, r in results]}; "
            f"itemsets {[len(r.itemsets) for _, _, r in results]} == host mine_prepost")

        # observability: a valid Chrome trace, periodic stats snapshots
        deadline = time.monotonic() + 5
        while emitter.stats["periodic"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        emitter.stop()
        lines = [json.loads(line) for line in sink.getvalue().splitlines()]
        tpath = Path(snap) / "trace.json"
        n_ev = rec.save_chrome(str(tpath))
        events = json.loads(tpath.read_text())
        if (emitter.stats["periodic"] < 2 or len(lines) != emitter.stats["emits"] or not events
                or n_ev != len(rec) or any(not {"name", "ph", "ts"} <= set(e) for e in events)):
            raise AssertionError(f"observability: emitter {emitter.stats}, {len(lines)} lines, "
                                 f"{n_ev} trace events of {len(rec)} spans")
        hists = lines[-1]["stats"]["histograms"]
        log(f"service observability: {n_ev} Chrome trace events, {emitter.stats['periodic']} periodic "
            f"+ 1 final stats snapshots; queue_wait p50 "
            f"{hists['admission.queue_wait_s']['p50_s'] * 1e3:.3f}ms, prep_wait p50 "
            f"{hists['scheduler.prep_wait_s']['p50_s'] * 1e3:.3f}ms, request p50 "
            f"{hists['service.request_s']['p50_s'] * 1e3:.1f}ms")

        # 7b. QoS and typed errors on the card
        rows, n_items = data["mushroom"]
        before = K.launches()
        err = svc.submit(rows, n_items, spec.with_(min_sup=0.2, deadline_s=1e-6)).exception(timeout=60)
        moved = moved_since(before)
        if not isinstance(err, DeadlineExceeded) or any(moved.values()):
            raise AssertionError(f"deadline: {err!r}, launches {moved}")
        with failures.installed(failures.ChaosInjector().arm("service.serve")):
            crashed = svc.submit(rows, n_items, spec.with_(min_sup=0.3)).exception(timeout=60)
        # the next batch serves: mushroom at 0.15 with early stop off, from the
        # cached prep (early stop is execution-only), so its waves run B1
        before = K.launches()
        after = svc.submit(rows, n_items, spec.with_(min_sup=0.15, early_stop=False)).result(timeout=600)
        b1 = moved_since(before)
        check_host("after the crashed batch", [("mushroom", "hprepost", after)])
        if (not isinstance(crashed, failures.SimulatedFailure) or svc.stats["worker_restarts"] != 1
                or after.service_stats["prep_source"] != "cache" or not b1["nlist_intersect"]
                or b1["nlist_intersect_es"] or b1["histogram"]):
            raise AssertionError(f"chaos: {crashed!r}, service {dict(svc.stats)}, then "
                                 f"{after.service_stats} with launches {b1}")
        svc.close()
        with MiningService(device="cuda", batch_window_s=0.0, max_queue_depth=1) as burst:
            # the burst lands while the worker serves a kosarak mine (its
            # fingerprint alone takes a few hundred ms): one fits the queue
            busy = burst.submit(*data["kosarak"], spec.with_(min_sup=0.01))
            deadline = time.monotonic() + 10
            while burst._q.depth and time.monotonic() < deadline:
                time.sleep(0.001)
            futs = [burst.submit(rows, n_items, spec.with_(min_sup=0.3)) for _ in range(6)]
            outs = [f.exception(timeout=600) or f.result() for f in futs]
            check_host("burst", [("kosarak", "hprepost", busy.result(timeout=600))])
        over = [o for o in outs if isinstance(o, Overloaded)]
        served = [o for o in outs if not isinstance(o, BaseException)]
        if not over or not served or len(over) + len(served) != len(outs):
            raise AssertionError(f"overload: {outs}")
        check_host("burst", [("mushroom", "hprepost", r) for r in served])
        log(f"service QoS: deadline passed -> DeadlineExceeded with launches {json.dumps(moved)}; "
            f"a chaos-crashed batch -> {type(crashed).__name__}, the next batch served mushroom@0.15 "
            f"with early stop off from the cached prep ({len(after.itemsets)} itemsets == host, "
            f"launches {json.dumps(b1)}); a burst of 6 at max_queue_depth=1 -> "
            f"{len(served)} served, {len(over)} Overloaded")

        # 7c. warm start: a second service on the first one's snapshots
        before = K.launches()
        with MiningService(device="cuda", snapshot_dir=snap, batch_window_s=0.05) as warm:
            t0 = time.perf_counter()
            res = [f.result(timeout=600) for f in warm.sweep(*data["kosarak"], spec, [0.02, 0.01])]
            warm_wall = time.perf_counter() - t0
            prepares, info = warm.engine.stats["prepares"], warm.engine.cache_info()
        moved = moved_since(before)
        if (prepares != 0 or moved["histogram"] or moved["cooccur"]
                or any(r.service_stats["prep_source"] != "snapshot" for r in res)):
            raise AssertionError(f"warm start: {prepares} prepares, cache {info}, launches {moved}")
        check_host("warm start", [("kosarak", "hprepost", r) for r in res])
        log(f"service warm start: kosarak sweep on a second service over the first one's snapshots "
            f"{warm_wall:.4f}s, 0 prepares, snapshot hits {info['snapshot_hits']}, launches {json.dumps(moved)}")

    # 7d. overlap on against off, on one resident service (its fingerprint
    # memo, miners and prep stream warm, as a long-lived service's are): the
    # prep cache is cleared before each batch so that every group prepares,
    # and each batch gets a fresh latency registry. After one warm-up batch,
    # on, off, off, on unprofiled, then under torch.profiler, then again
    # unprofiled with the interpreter's thread switch interval at 0.1 ms
    # (from 5 ms): the serving and prep threads share the GIL
    eng = MiningEngine(device="cuda")
    svc = MiningService(eng, batch_window_s=0.05)
    per_batch = {}
    default_switch = sys.getswitchinterval()
    runs = [(None, False, default_switch)]
    runs += [(ov, False, default_switch) for ov in (True, False, False, True)]
    runs += [(ov, True, default_switch) for ov in (True, False, False, True)]
    runs += [(ov, False, 1e-4) for ov in (True, False, False, True)]
    try:
        for overlap, profiled, switch in runs:
            warmup = overlap is None
            svc.scheduler.overlap = True if warmup else overlap
            svc.engine.clear_prep_cache()
            svc.engine.telemetry = svc.scheduler.telemetry = Registry()
            sys.setswitchinterval(switch)
            before, c0 = K.launches(), counts(svc)
            if profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    results, wall = serve_load(svc, data)
            else:
                results, wall = serve_load(svc, data)
            sys.setswitchinterval(default_switch)
            moved = moved_since(before)
            what = ("warm-up" if warmup else f"overlap={overlap}") + f" profiled={profiled} " \
                f"switch={switch * 1e3:g}ms"
            check_batch(what, svc, results, c0, moved, overlap=svc.scheduler.overlap)
            per_batch.setdefault(json.dumps(moved, sort_keys=True), []).append(what)
            h = svc.engine.telemetry.snapshot()["histograms"]
            line = (f"service {what}: batch wall {wall * 1e3:.2f}ms, prep_wait p50 "
                    f"{h['scheduler.prep_wait_s']['p50_s'] * 1e3:.3f}ms (sum "
                    f"{h['scheduler.prep_wait_s']['sum_s'] * 1e3:.2f}), prep sum "
                    f"{h['engine.prep_s']['sum_s'] * 1e3:.2f}ms, serve sum "
                    f"{h['scheduler.serve_s']['sum_s'] * 1e3:.2f}ms")
            if profiled:
                tl = device_timeline(prof)
                if tl["busy_ms"] <= 0:
                    line += ", device time not measured (the profiler recorded none)"
                else:
                    line += (f", device busy {tl['busy_ms']:.2f}ms, idle share "
                             f"{1 - tl['busy_ms'] / (wall * 1e3):.3f}, streams prep {tl['prep_streams']} "
                             f"wave {tl['wave_streams']}, both streams busy at once "
                             + ("n/a (one stream)" if tl["concurrent_ms"] is None
                                else f"{tl['concurrent_ms']:.3f}ms"))
            log(line)
    finally:
        sys.setswitchinterval(default_switch)
        svc.close()
    if len(per_batch) != 1:
        raise AssertionError(f"launch counts differ between overlap on and off: {per_batch}")
    got = K.launches()
    if not all(got.values()):
        raise AssertionError(f"a kernel was not launched in phase 7: {got}")
    return got


def stream_phase(K, data, host, smi: str):
    """Phase 8: streaming and continuous mining on the card (see the module
    docstring). Every time printed carries ``smi``, the card's name and
    power limit. -> (this phase's launches, the kernel entries at a pumsb
    segment's shapes, 8a's 4-batch mushroom answers and query walls)."""
    from repro_torch.core import encoding as enc
    from repro_torch.data.synth import random_db
    from repro_torch.kernels.cooccur import ref as cooc_ref
    from repro_torch.kernels.cooccur.ops import cooccur_cost
    from repro_torch.kernels.nlist_intersect import ref as nl_ref
    from repro_torch.kernels.nlist_intersect.ops import wave_cost
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.mining import MineSpec, MiningEngine, MiningService
    from repro_torch.mining.continuous import damped_oracle, replay_diffs
    from repro_torch.mining.stream import StreamSpec

    dev = "cuda"

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def moved_since(before):
        return {k: v - before[k] for k, v in K.launches().items()}

    def check_host(what, name, res):
        want = host_answer(data, host, name, res.min_count)
        if res.itemsets != want:
            raise AssertionError(f"{what} at min_count {res.min_count}: {len(res.itemsets)} "
                                 f"itemsets vs {len(want)} from the host PrePost miner")

    def seg_waves(stream):
        return stream.miner.stage_counters.get("seg_waves", 0)

    def append_all(eng, batches, n_items, spec, what):
        """Append every batch, checking that each prepares its batch alone
        (one B4 launch, no other kernel, one more seg_prepare, built).
        -> (per-append wall seconds, the stream)."""
        walls = []
        for i, b in enumerate(batches):
            before = K.launches()
            sm = eng.stream(n_items=n_items, spec=spec)
            p0 = sm.stats["seg_prepares"]
            st, wall = timed(lambda: eng.append(b, n_items, spec=spec))
            moved = moved_since(before)
            if (st["prep_source"] != "built" or sm.stats["seg_prepares"] != p0 + 1
                    or moved != {**{k: 0 for k in moved}, "cooccur": 1}):
                raise AssertionError(f"{what} append {i}: {st}, launches {moved}")
            walls.append(wall)
        return walls, eng.stream()

    def query(eng, spec, what, stream="default"):
        """One stream query: B1 once per segment per wave, no other kernel.
        -> (result, wall seconds)."""
        sm = eng.stream(stream)
        w0, s0, before = sm.miner.stage_counters["waves"], seg_waves(sm), K.launches()
        res, wall = timed(lambda: eng.submit_stream(spec, stream=stream))
        moved = moved_since(before)
        waves, sw = sm.miner.stage_counters["waves"] - w0, seg_waves(sm) - s0
        n_seg = res.service_stats["stream_segments"]
        if (sw != waves * n_seg or moved["nlist_intersect"] != sw
                or any(v for k, v in moved.items() if k != "nlist_intersect")):
            raise AssertionError(f"{what}: {waves} waves over {n_seg} segments, seg_waves {sw}, "
                                 f"launches {moved}")
        return res, wall

    K.reset_launches()
    spec = MineSpec(algorithm="hprepost")
    fracs = [0.3, 0.2, 0.15]
    rows, n_items = data["mushroom"]
    oneshot = MiningEngine(device=dev, prep_cache_bytes=0)

    # 8a. mushroom streamed as 4 and as 16 batches; 8c. each append against a
    # one-shot prepare of every row so far, queries against a warm monolith
    mono = MiningEngine(device=dev)
    mono.submit(rows, n_items, spec.with_(min_sup=0.15))  # warm: cached prep
    mono_s = [timed(lambda: mono.submit(rows, n_items, spec.with_(min_sup=0.15)))[1]
              for _ in range(3)]
    rebuild_fe = MiningEngine(device=dev, prep_cache_bytes=0).frontend("hprepost")
    snap_dir = tempfile.mkdtemp(prefix="chip-smoke-stream-")
    streams = {}
    try:
        for S in (4, 16):
            batches = np.array_split(rows, S)
            eng = MiningEngine(device=dev, snapshot_dir=snap_dir if S == 4 else None)
            walls, sm = append_all(eng, batches, n_items, spec, f"mushroom/{S}")
            hist_s = [timed(lambda b=b: enc.item_support(b, n_items))[1] for b in batches]
            results = []
            for f in fracs:
                res, wall = query(eng, spec.with_(min_sup=f), f"mushroom/{S} query {f}")
                want = oneshot.submit(rows, n_items, spec.with_(min_sup=f))
                if res.itemsets != want.itemsets or res.n_rows != len(rows):
                    raise AssertionError(f"mushroom/{S} at {f}: {len(res.itemsets)} itemsets over "
                                         f"{res.n_rows} rows vs the one-shot mine's {len(want.itemsets)}")
                check_host(f"mushroom/{S} query {f}", "mushroom", res)
                results.append((f, res, wall))
            q_s = [query(eng, spec.with_(min_sup=0.15), f"mushroom/{S} timed query")[1]
                   for _ in range(3)]
            segs = sm.db.segments
            log(f"stream mushroom/{S}: {len(rows)} rows in {S} batches, segments K_s "
                f"{[s.k for s in segs][:4]}{'...' if S > 4 else ''} W_s "
                f"{sorted({s.prepared.width for s in segs})}, planes {sum(s.device_bytes for s in segs)} "
                f"bytes on the device; append walls {[round(w * 1e3, 2) for w in walls]}ms "
                f"(host histogram {[round(h * 1e3, 2) for h in hist_s]}ms, prep stages "
                f"{[round(sum(s.prepared.stage_times.values()) * 1e3, 2) for s in segs]}ms); "
                f"sweep {[(f, len(r.itemsets), round(w * 1e3, 2)) for f, r, w in results]} "
                f"(itemsets, ms) == one-shot == host mine_prepost; query@0.15 "
                f"{[round(t * 1e3, 2) for t in q_s]}ms against the warm monolithic mine "
                f"{[round(t * 1e3, 2) for t in mono_s]}ms [{smi}]")
            if S == 16:
                # 8c. the full-rebuild baseline: a one-shot prepare (Job 1, Job 2,
                # F2) of every row so far at the sweep's loosest floor
                rebuild = []
                for i in range(1, S + 1):
                    seen = np.concatenate(batches[:i])
                    floor = spec.with_(min_sup=0.15).resolve(len(seen))
                    rebuild.append(timed(lambda: rebuild_fe.prepare(seen, n_items, floor, spec))[1])
                log(f"stream append against rebuild, mushroom/16: appends "
                    f"{[round(w * 1e3, 2) for w in walls]}ms (sum {sum(walls) * 1e3:.2f}), one-shot "
                    f"prepare of all rows so far {[round(w * 1e3, 2) for w in rebuild]}ms (sum "
                    f"{sum(rebuild) * 1e3:.2f}) [{smi}]")
                before = results[-1][1].itemsets
                passes = []
                while len(sm.db.segments) > 1:
                    n0 = len(sm.db.segments)
                    _, wall = timed(sm.compact)
                    passes.append((n0, len(sm.db.segments), round(wall * 1e3, 2)))
                res, wall = query(eng, spec.with_(min_sup=0.15), "mushroom after compaction")
                if res.itemsets != before or sm.stats["compactions"] != len(passes):
                    raise AssertionError(f"compaction changed the answer or miscounted: {sm.stats}")
                log(f"stream compaction mushroom/16: passes (segments before, after, ms) {passes}; "
                    f"query@0.15 on 1 segment {wall * 1e3:.2f}ms, answer unchanged [{smi}]")
            streams[S] = (eng, batches)
            if S == 4:  # phase 10 holds the distributed database to these
                stream4 = dict(answers={f: r.itemsets for f, r, _ in results},
                               query_s=q_s)

        # 8b. pumsb at its full width: every item of a batch in its segment
        prows, pn = data["pumsb"]
        pspec = spec.with_(max_f1=8192)
        pb = np.array_split(prows, 4)
        peng = MiningEngine(device=dev)
        psm = peng.stream(n_items=pn, spec=pspec)
        add_s = []
        add = psm.db.add_segment

        def timed_add(seg):  # the host fold of a segment's F2 block
            t0 = time.perf_counter()
            add(seg)
            add_s.append(time.perf_counter() - t0)

        psm.db.add_segment = timed_add
        walls, _ = append_all(peng, pb, pn, pspec, "pumsb/4")
        pres, pwall = query(peng, pspec.with_(min_sup=0.15), "pumsb/4 query 0.15")
        want = oneshot.submit(prows, pn, spec.with_(min_sup=0.15))
        if pres.itemsets != want.itemsets:
            raise AssertionError(f"pumsb stream: {len(pres.itemsets)} itemsets vs the one-shot "
                                 f"mine's {len(want.itemsets)}")
        check_host("pumsb stream query 0.15", "pumsb", pres)
        C = psm.db.C
        mc = pres.min_count
        (_, t_plan) = timed(lambda: (np.packbits((C + C.T) >= mc, axis=1),
                                     np.packbits(np.tri(len(C), len(C), -1, dtype=bool), axis=1)))
        segs = psm.db.segments
        log(f"stream pumsb/4 (max_f1=8192): segments K_s {[s.k for s in segs]}, W_s "
            f"{[s.prepared.width for s in segs]}, planes bytes {[s.device_bytes for s in segs]}; "
            f"append walls {[round(w * 1e3, 1) for w in walls]}ms (prep stages "
            f"{[{k: round(v * 1e3, 1) for k, v in s.prepared.stage_times.items()} for s in segs]}ms, "
            f"host add_segment {[round(t * 1e3, 1) for t in add_s]}ms); query@0.15 "
            f"{pwall * 1e3:.1f}ms with planning tables (pair_ok, prefix) {t_plan * 1e3:.1f}ms on "
            f"K={len(C)}; {len(pres.itemsets)} itemsets == one-shot == host mine_prepost [{smi}]")
        phase = K.launches()  # the main path's launches, before the kernel checks

        # B4 and B1 at a pumsb segment's shapes, against their plain versions
        seg, b0 = segs[0], pb[0]
        lut = torch.from_numpy(seg.prepared.fl.rank_lut()).to(dev)
        ranked = enc.rank_encode_torch(torch.from_numpy(b0).to(dev), lut, pn)
        wr = torch.ones(ranked.shape[0], dtype=torch.int32, device=dev)
        err = assert_equal("cooccur pumsb segment",
                           (K.cooccur_cuda(ranked, wr, n_items=seg.k),),
                           (cooc_ref.cooccur_ref(ranked, wr, n_items=seg.k),))
        R, L = ranked.shape
        nb, pairs = cooccur_cost(ranked, wr, n_items=seg.k)
        b, by = bound_ms(nb, pairs)
        cooc = dict(shape=f"pumsb stream segment: ranked rows {R}x{L}, K={seg.k}, {pairs} pair "
                          f"updates", max_abs_err=err,
                    ms=time_ms(lambda: K.cooccur_cuda(ranked, wr, n_items=seg.k)),
                    plain_ms=time_ms(lambda: cooc_ref.cooccur_ref(ranked, wr, n_items=seg.k),
                                     reps=2),
                    **cooccur_library(ranked, wr, seg.k, K.cooccur_cuda(ranked, wr, n_items=seg.k),
                                      reps=3),
                    bound_ms=b, bound_by=by)
        extras = cooccur_extras(ranked, wr, seg.k)
        log_cooccur_extras(f"a pumsb segment (K={seg.k})", extras, smi)
        cooc.update(measured_extras(extras))
        del ranked, wr, lut
        h = psm.db.handles()[0]
        planes = h.planes[0]  # the one data shard
        single = planes[2]
        qs, ps = np.nonzero(C >= mc)
        ranks = np.stack([qs, ps], axis=1).astype(np.int32)
        idx, _, _ = psm.miner._pack_wave(ranks, ps.astype(np.int64), qs.astype(np.int32))
        local = torch.from_numpy(np.stack([h.g2l[idx[0]], h.g2l[idx[1]], h.g2l[idx[2]]])
                                 .astype(np.int64)).to(dev)
        n_live = len(ranks)
        got = K.nlist_wave_cuda(planes, single, local, n_live)
        err = assert_equal("nlist_intersect pumsb segment", got,
                           nl_ref.nlist_wave_ref(planes, single, local, n_live))
        nb, ops = wave_cost(planes, single, local, n_live)
        W = planes.shape[2]
        nz = ops // (math.ceil(math.log2(W)) + 2)
        b, by = bound_ms(nb, ops)
        wave = dict(shape=f"pumsb stream segment level-2 wave: {n_live} candidates, Cpad "
                          f"{idx.shape[1]} x W {W}, planes (3, {seg.k + 1}, {W}) with the "
                          f"sentinel row, {nz} nonzero Y codes", max_abs_err=err,
                    ms=time_ms(lambda: K.nlist_wave_cuda(planes, single, local, n_live)),
                    plain_ms=time_ms(lambda: nl_ref.nlist_wave_ref(planes, single, local,
                                                                   n_live), reps=2),
                    library_ms=None, bound_ms=b, bound_by=by)
        log(f"  B4 equal to its plain version at a pumsb segment (K={seg.k}): {cooc['ms']:.4f}ms "
            f"against plain {cooc['plain_ms']:.2f}ms, weighted one-hot fp32 {cooc['library_ms']:.2f}ms "
            f"(bf16 {cooc['bf16_ms']:.2f}, int8 {cooc['int8_ms']:.2f}), "
            f"bound {cooc['bound_ms']:.4f}ms; B1 equal at "
            f"its level-2 wave: {wave['ms']:.4f}ms against plain {wave['plain_ms']:.2f}ms, bound "
            f"{wave['bound_ms']:.4f}ms [{smi}]")
        extra = {"cooccur": cooc, "nlist_intersect": wave}
        del local, got, h, planes, single
        del psm, peng, segs, seg, C
        gc.collect()

        # 8d. a sliding window of 4 batches, with a standing query registered
        # before the first append, and a decayed stream
        K.reset_launches()
        batches = streams[16][1]
        weng = MiningEngine(device=dev)
        wspec = spec.with_(min_sup=0.2)
        weng.stream(n_items=n_items, spec=spec, stream_spec=StreamSpec(window_batches=4))
        sq = weng.register_standing(wspec)
        reps = [timed(lambda b=b: weng.append(b, n_items))[0] for b in batches]
        wres, _ = query(weng, wspec, "windowed query")
        window = np.concatenate(batches[-4:])
        want = oneshot.submit(window, n_items, wspec)
        wst = weng.stream_stats()["default"]
        if (wres.itemsets != want.itemsets or wres.n_rows != len(window)
                or wst["expires"] != len(batches) - 4 or wst["expired_rows"] != len(rows) - len(window)):
            raise AssertionError(f"window: {len(wres.itemsets)} itemsets over {wres.n_rows} rows vs "
                                 f"{len(want.itemsets)} over {len(window)}; stats {wst}")
        if not (replay_diffs(sq.diffs) == sq.latest == wres.itemsets) or len(sq.diffs) != len(batches) + 1:
            raise AssertionError(f"standing query: {len(sq.diffs)} diffs do not replay to the answer")
        lat = [round(d.latency_s * 1e3, 2) for d in sq.diffs]
        log(f"stream window mushroom/16 batches, window 4: {wres.n_rows} rows retained, "
            f"{len(wres.itemsets)} itemsets == one-shot over the window; expires {wst['expires']}, "
            f"expired_rows {wst['expired_rows']}; standing query: {len(sq.diffs)} diffs replay to the "
            f"answer, refresh latencies {lat}ms, seed-pruned {wst['seed_pruned_candidates']}, append "
            f"walls with refresh {[round(r['append_s'] * 1e3, 2) for r in reps]}ms [{smi}]")
        rng = np.random.default_rng(8)
        dbatches = [random_db(rng, n, 12, 6) for n in (300, 220, 260, 240)]
        dspec = spec.with_(min_sup=None, min_count=25)
        dres = []
        for d in (dev, "cpu"):
            e = MiningEngine(device=d)
            for b in dbatches:
                e.append(b, 12, spec=dspec, stream_spec=StreamSpec(decay=0.9))
            dres.append(e.submit_stream(dspec).itemsets)
        oracle = damped_oracle(dbatches, 12, 0.9, 25.0)
        if dres[0] != dres[1] or set(dres[0]) != set(oracle) or any(
                abs(v - oracle[t]) > 1e-9 * abs(oracle[t]) for t, v in dres[0].items()):
            raise AssertionError("decayed stream: the card's answer differs from the CPU port's "
                                 "or from damped_oracle")
        log(f"stream decay 0.9: {len(dres[0])} itemsets, the card's float64 supports equal the CPU "
            f"port's bit for bit and damped_oracle's within 1e-9 relative")

        # 8e. warm start: a second engine replays 8a's 4-batch append log
        before = K.launches()
        warm = MiningEngine(device=dev, snapshot_dir=snap_dir)
        for b in streams[4][1]:
            st = warm.append(b, n_items, spec=spec)
            if st["prep_source"] != "snapshot":
                raise AssertionError(f"replayed append: {st}")
        moved = moved_since(before)
        wsm = warm.stream()
        if wsm.stats["seg_prepares"] != 0 or moved["cooccur"] or moved["histogram"]:
            raise AssertionError(f"replay: stats {wsm.stats}, launches {moved}")
        r_w, _ = query(warm, spec.with_(min_sup=0.15), "replayed stream query")
        check_host("replayed stream", "mushroom", r_w)
        log(f"stream warm start: 4 appends replayed from snapshots, seg_prepares 0, snapshot hits "
            f"{wsm.stats['seg_snapshot_hits']}, launches {json.dumps(moved)}; query@0.15 "
            f"{len(r_w.itemsets)} itemsets == host mine_prepost")
        del warm, wsm
    finally:
        import shutil

        shutil.rmtree(snap_dir, ignore_errors=True)

    # the service's stream lane: two producer threads append alternate
    # batches, each following every append with a stream query
    with MiningService(device=dev, batch_window_s=0.02) as svc:
        qspec = spec.with_(min_sup=0.2)
        svc.engine.stream("svc", n_items=n_items, spec=spec)
        standing = svc.register_standing(qspec, stream="svc").result(timeout=120)
        batches = streams[16][1]
        halves = [batches[0::2], batches[1::2]]
        futs = [[], []]
        errors = []
        start = threading.Barrier(3)

        def producer(i):
            start.wait()
            try:
                seen = 0
                for b in halves[i]:
                    futs[i].append(("append", len(b), svc.append(b, stream="svc")))
                    seen += len(b)
                    futs[i].append(("query", seen, svc.submit_stream(qspec, stream="svc")))
            except BaseException as e:  # surfaced below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=producer, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(60)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"a stream producer failed or hung: {errors}")
        for plan in futs:
            for kind, n, f in plan:
                out = f.result(timeout=600)
                # a query submitted after this thread's appends sees them all
                if kind == "query" and out.n_rows < n:
                    raise AssertionError(f"a stream query saw {out.n_rows} rows after {n} were appended")
        lane_wall = time.perf_counter() - t0
        final, _ = query(svc.engine, qspec, "served stream, final", stream="svc")
        check_host("served stream", "mushroom", final)
        snap = svc.stats()
        if (final.n_rows != len(rows) or "svc" not in snap["streams"]
                or snap["streams"]["svc"]["appends"] != len(batches)
                or not (replay_diffs(standing.diffs) == standing.latest == final.itemsets)):
            raise AssertionError(f"service stream lane: {final.n_rows} rows, streams "
                                 f"{sorted(snap['streams'])}, {len(standing.diffs)} diffs")
        log(f"service stream lane: {len(batches)} appends and {len(batches)} stream queries from 2 "
            f"producer threads in {svc.stats['batches']} batches, {lane_wall:.3f}s; final "
            f"{len(final.itemsets)} itemsets == host; standing query {len(standing.diffs)} diffs replay "
            f"to it; stats()['streams'] holds {sorted(snap['streams'])} [{smi}]")

        # an async compaction racing a served query
        rspec = StreamSpec(compact_async=True)
        svc.engine.stream("race", n_items=n_items, spec=spec, stream_spec=rspec)
        for f in [svc.append(b, stream="race") for b in streams[4][1]]:
            f.result(timeout=120)
        first = svc.submit_stream(qspec, stream="race").result(timeout=120)
        rsm = svc.engine.stream("race")
        rsm.compact(wait=False)
        during = svc.submit_stream(qspec, stream="race").result(timeout=120)
        rsm.flush()
        after = svc.submit_stream(qspec, stream="race").result(timeout=120)
        merged = [s for s in rsm.db.segments if s.n_batches > 1]
        if (not (first.itemsets == during.itemsets == after.itemsets) or rsm.stats["compactions"] != 1
                or len(merged) != 1 or merged[0].ready is None):
            raise AssertionError(f"async compaction race: stats {rsm.stats}")
        log(f"service async compaction racing a query: answers before, during and after equal "
            f"({len(after.itemsets)} itemsets), segments {first.service_stats['stream_segments']} -> "
            f"{after.service_stats['stream_segments']}, merged segment handed over by an event")
        rsm.close()
    got = K.launches()
    total = {k: phase[k] + got[k] for k in got}
    if not (total["nlist_intersect"] and total["cooccur"]):
        raise AssertionError(f"a kernel of the streaming path was not launched in phase 8: {total}")
    return total, extra, stream4


def mesh_phase(K, data, host, smi: str, oneshot: dict, dev="cuda") -> dict[str, int]:
    """Phase 9: HPrepost on D×M meshes whose positions all share ``dev`` (see
    the module docstring). ``oneshot`` maps each dataset to phase 4's 1×1
    itemsets. Every number printed carries ``smi``, the card's name and power
    limit. -> this phase's launches."""
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.mining import MineSpec, MiningEngine, MiningService

    dev = torch.device(dev)
    axes = ("data", "model")
    pad = np.iinfo(np.int32).max
    sups = {"mushroom": 0.15, "pumsb": 0.15, "kosarak": 0.01}
    # (shape, locality dispatch): the shuffle on (2, 2), B2 per group on (1, 2)
    meshes = [((2, 1), True), ((4, 1), True), ((4, 2), True), ((2, 2), False), ((1, 2), True)]
    total = {k: 0 for k in K.launches()}
    gc.collect()  # what earlier phases dropped must not count in this phase's peaks

    def on_card(shape):
        return make_mesh(shape, axes, [dev] * math.prod(shape))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def counted(fn):
        """``fn()`` with every launch count set to 0 just before and read
        just after. -> (result, wall seconds, launches)."""
        sync()
        K.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        got = K.launches()
        for k, v in got.items():
            total[k] += v
        return out, wall, got

    def check(what, name, itemsets, min_count, vs_oneshot=True):
        want = host_answer(data, host, name, min_count)
        if itemsets != want or (vs_oneshot and itemsets != oneshot[name]):
            raise AssertionError(f"{what}: {len(itemsets)} itemsets vs {len(want)} from the host "
                                 f"PrePost miner, {len(oneshot[name])} from phase 4's 1x1 mine")

    # 9a. one-shot mines on every mesh, each paying for its own prepare
    for name, sup in sups.items():
        rows, n_items = data[name]
        mc = max(1, math.ceil(sup * len(rows) - 1e-9))
        compared = set()  # data-shard counts whose payload was held to the CPU mesh's
        for shape, loc in meshes:
            spec = MineSpec(algorithm="hprepost", min_sup=sup)
            if loc:
                eng = MiningEngine(mesh=on_card(shape), prep_cache_bytes=0)
                miner = eng.frontend("hprepost").miner_for(spec)
                run = lambda: eng.submit(rows, n_items, spec).itemsets  # noqa: E731
            else:
                # MineSpec has no locality knob (nor has the reference's): the
                # shuffle runs through the miner itself
                miner = HPrepostMiner(config=HPrepostConfig(locality_dispatch=False),
                                      mesh=on_card(shape))
                run = lambda: miner.mine(rows, n_items, mc).itemsets  # noqa: E731
            D, Mb = miner.D, miner._Mb
            peak = "not measured"
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            w0 = miner.stage_counters["waves"]
            itemsets, wall, got = counted(run)
            if dev.type == "cuda":
                peak = (f"{(torch.cuda.max_memory_allocated() - base) / MB:.1f} MiB above the "
                        f"{base / MB:.1f} MiB held before")
            waves = miner.stage_counters["waves"] - w0
            launches = waves * D * Mb
            want = {"histogram": D, "cooccur": D, "nlist_intersect": launches if D > 1 else 0,
                    "nlist_intersect_es": 0 if D > 1 else launches}
            if got != want or waves == 0:
                raise AssertionError(f"mesh {name} {shape}: {waves} waves, launches {got}, "
                                     f"expected {want}")
            check(f"mesh {name} {shape} locality {loc}", name, itemsets, mc)
            # the per-reducer state: one more prepare, outside the counted run
            prep = miner.prepare(rows, n_items, mc)
            shard_bytes = [int(p.numel() * 4) for p in prep.packed]
            nodes = [int((p[..., 0] != pad).sum()) for p in prep.packed]
            held = ""
            if (name == "mushroom" or (name == "pumsb" and D > 1)) and D not in compared:
                ref = HPrepostMiner(mesh=make_mesh(shape, axes, ["cpu"] * math.prod(shape)))
                want_p, got_p = ref.prepare(rows, n_items, mc).to_host(), prep.to_host()
                for k, v in want_p.items():
                    g = got_p[k]
                    if isinstance(v, np.ndarray):
                        same = v.dtype == g.dtype and v.shape == g.shape and v.tobytes() == g.tobytes()
                    else:
                        same = type(v) is type(g) and v == g
                    if not same:
                        raise AssertionError(f"mesh {name} {shape}: payload {k!r} differs from "
                                             f"the CPU mesh's")
                compared.add(D)
                held = f", to_host() payload (D={D}) equal to a CPU mesh's key by key"
            log(f"mesh {name}@{sup} {shape} locality {loc}: wall {wall:.4f}s, "
                f"{len(itemsets)} itemsets == host mine_prepost == phase 4 (1x1); K {prep.fl.k}, "
                f"W {prep.width}, per-shard packed bytes {shard_bytes}, tree nodes {nodes}, "
                f"prep_bytes {prep.prep_bytes}, peak device memory {peak}, {waves} waves, "
                f"launches {json.dumps(got)}, distinct cards {len(miner.devices)}{held} [{smi}]")
            del prep, miner
            gc.collect()

    # 9b. a (2, 1) snapshot warm-starts (2, 2) with no prepare; (1, 1) rebuilds
    rows, n_items = data["mushroom"]
    spec = MineSpec(algorithm="hprepost", min_sup=0.15)
    with tempfile.TemporaryDirectory() as snap:
        runs = []
        for shape in ((2, 1), (2, 2), (1, 1)):
            eng = MiningEngine(mesh=on_card(shape), snapshot_dir=snap)
            res, wall, got = counted(lambda: eng.submit(rows, n_items, spec))
            check(f"snapshot {shape}", "mushroom", res.itemsets, res.min_count)
            runs.append((shape, res.service_stats["prep_source"], got, wall,
                         eng.cache_info()["snapshot_hits"]))
        sources = [r[1] for r in runs]
        warm = runs[1][2]
        if sources != ["built", "snapshot", "built"] or warm["histogram"] or warm["cooccur"]:
            raise AssertionError(f"mesh snapshots: {runs}")
        log("mesh snapshot mushroom@0.15: " + "; ".join(
            f"{s} {src} in {w:.4f}s (B3 {g['histogram']}, B4 {g['cooccur']}, snapshot hits {h})"
            for s, src, g, w, h in runs) + f" [{smi}]")

    # 9c. one (2, 2) service batch: the mushroom sweep and pumsb
    rows_p, n_p = data["pumsb"]
    with MiningService(mesh=on_card((2, 2)), batch_window_s=0.05) as svc:
        def batch():
            futs = svc.sweep(rows, n_items, spec, [0.3, 0.2, 0.15])
            futs.append(svc.submit(rows_p, n_p, spec))
            return [f.result(timeout=300) for f in futs]

        results, wall, got = counted(batch)
        streams = len(svc.scheduler.prep_streams)
    for r, name in zip(results, ["mushroom"] * 3 + ["pumsb"]):
        check(f"mesh service {name} at {r.min_count}", name, r.itemsets, r.min_count,
              vs_oneshot=r.min_count == max(1, math.ceil(0.15 * len(data[name][0]) - 1e-9)))
    if got["histogram"] != 4 or got["cooccur"] != 4 or got["nlist_intersect_es"]:
        raise AssertionError(f"mesh service: launches {got}")
    log(f"mesh service (2, 2): mushroom sweep 0.3/0.2/0.15 + pumsb@0.15 in one batch, wall "
        f"{wall:.4f}s, {[len(r.itemsets) for r in results]} itemsets == host mine_prepost, "
        f"launches {json.dumps(got)}, {streams} prep stream(s) [{smi}]")

    # 9d. mushroom streamed as 4 batches into a (2, 1) mesh
    eng = MiningEngine(mesh=on_card((2, 1)))

    def stream():
        for b in np.array_split(rows, 4):
            eng.append(b, n_items, spec=spec)
        return eng.submit_stream(spec)

    res, wall, got = counted(stream)
    sm = eng.stream()
    check("mesh stream (2, 1)", "mushroom", res.itemsets, res.min_count)
    seg_waves = sm.miner.stage_counters.get("seg_waves", 0)
    if (got["cooccur"] != 4 * 2 or got["histogram"] or got["nlist_intersect_es"]
            or got["nlist_intersect"] != seg_waves * 2 or not seg_waves):
        raise AssertionError(f"mesh stream: {seg_waves} segment waves, launches {got}")
    log(f"mesh stream (2, 1): mushroom as 4 batches then a query at 0.15, wall {wall:.4f}s, "
        f"{len(res.itemsets)} itemsets == host mine_prepost, {seg_waves} segment waves, "
        f"launches {json.dumps(got)} [{smi}]")
    del eng, sm
    gc.collect()

    # 9e. where the time goes: each dataset warm on (1, 1) and on (4, 2),
    # under the profiler (device busy = union of kernel, copy, memset spans)
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for name, sup in sups.items():
            rows, n_items = data[name]
            spec = MineSpec(algorithm="hprepost", min_sup=sup)
            for shape in ((1, 1), (4, 2)):
                eng = MiningEngine(mesh=on_card(shape), prep_cache_bytes=0)
                counted(lambda: eng.submit(rows, n_items, spec))  # warm-up
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _, wall, got = counted(lambda: eng.submit(rows, n_items, spec))
                tl = device_timeline(prof)
                log(f"mesh profile {name}@{sup} {shape} (warm): wall {wall * 1e3:.1f}ms, device busy "
                    f"{tl['busy_ms']:.1f}ms, idle share {1 - tl['busy_ms'] / (wall * 1e3):.3f}, "
                    f"{tl['device_events']} device events, launches {json.dumps(got)} [{smi}]")
                del eng
    if not all(total.values()):
        raise AssertionError(f"a kernel of the mesh path was not launched in phase 9: {total}")
    return total


def distributed_phase(K, data, host, smi: str, stream4: dict, oneshot: dict,
                      dev="cuda") -> dict[str, int]:
    """Phase 10: HPrepost's JobTracker and TaskTrackers as live processes
    (see the module docstring). ``stream4`` holds phase 8a's 4-batch
    mushroom answers and query walls, ``oneshot`` phase 4's answers. The
    kernels run in the worker processes, whose launch counters start at 0
    when they are spawned and are read through ``worker_stats()`` before a
    worker is killed or closed; the coordinator launches nothing. Every
    number printed carries ``smi``. -> the workers' launches.
    ``dev="cpu"`` rehearses the phase on the CPU (nothing launches there)."""
    import multiprocessing

    from repro_torch.mining import MineSpec, MiningEngine, MiningService
    from repro_torch.mining.distributed import protocol

    counting = dev == "cuda"
    spec = MineSpec(algorithm="hprepost")
    fracs = [0.3, 0.2, 0.15]
    rows, n_items = data["mushroom"]
    batches = np.array_split(rows, 4)
    snap_dir = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    eng = MiningEngine(device=dev, snapshot_dir=snap_dir)
    seen: dict[tuple[str, int], dict] = {}  # (database, wid) -> last launch reading
    hellos: dict[tuple[str, int], float] = {}
    dbs = []

    def read(dm):
        """Every live worker's stats reply; keeps its launch counters."""
        ws = dm.worker_stats()
        for wid, st in ws.items():
            seen[dm.name, wid] = st["launches"]
            hellos[dm.name, wid] = dm._workers[wid].hello_s
        return ws

    def moved(dm, key):
        return sum(v[key] for (name, _), v in seen.items() if name == dm.name)

    def open_db(name, n, sp, engine=eng, **kw):
        t0 = time.perf_counter()
        dm = engine.distribute(name, n_items=n, workers=2, spec=sp, **kw)
        dbs.append(dm)
        devs = sorted((w.wid, w.device) for w in dm._live())
        want = [(w, f"cuda:{w % torch.cuda.device_count()}" if counting else dev) for w, _ in devs]
        if devs != want:
            raise AssertionError(f"{name}: workers bound {devs}, not {want}")
        log(f"dist {name}: 2 workers spawned in {time.perf_counter() - t0:.2f}s, "
            + ", ".join(f"worker {w.wid} on {w.device} pid {w.pid} spawn-to-hello {w.hello_s:.2f}s"
                        for w in sorted(dm._live(), key=lambda w: w.wid)) + f" [{smi}]")
        return dm

    def timed(fn):
        if counting:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    # the bytes of every reply frame the coordinator reads
    recv_exact = protocol._recv_exact
    wire = [0]

    def counted(sock, n):
        wire[0] += n
        return recv_exact(sock, n)

    def smi_used() -> str:
        """Device-wide used memory (nvidia-smi)."""
        if not counting:
            return "not measured"
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    # 10d's reference answer, mined here before the launch counts start
    plus = np.concatenate([rows, batches[0]])
    want_plus = MiningEngine(device=dev).submit(plus, n_items, spec.with_(min_sup=0.15)).itemsets
    protocol._recv_exact = counted
    used_before = smi_used()
    K.reset_launches()
    try:
        # 10a. mushroom as 4 appends, placed over both workers; the sweep
        dm = open_db("mushroom", n_items, spec)
        walls = []
        for i, b in enumerate(batches):
            st, wall = timed(lambda b=b: dm.append(b))
            if st["prep_source"] != "built" or st["worker"] not in (0, 1):
                raise AssertionError(f"distributed append {i}: {st}")
            walls.append(wall)
        placed = {m.worker for m in dm._segments.values()}
        ws = read(dm)
        for wid, st in ws.items():
            built = st["stats"]["seg_prepares"]
            if counting and (st["launches"]["cooccur"] != built or st["launches"]["histogram"]):
                raise AssertionError(f"worker {wid} built {built} segments, launches {st['launches']}")
        if placed != {0, 1}:
            raise AssertionError(f"placement used workers {placed}, not both")
        w0 = dm._miner.stage_counters.get("waves", 0)
        b1_0 = sum(st["launches"]["nlist_intersect"] for st in ws.values())
        sweep = []
        for f in fracs:
            res, wall = timed(lambda f=f: dm.mine(spec.with_(min_sup=f)))
            want = host_answer(data, host, "mushroom", res.min_count)
            if (res.itemsets != want or res.itemsets != stream4["answers"][f]
                    or (f == 0.15 and res.itemsets != oneshot["mushroom"])):
                raise AssertionError(f"distributed mushroom at {f}: {len(res.itemsets)} itemsets vs "
                                     f"host {len(want)}, 8a {len(stream4['answers'][f])}")
            sweep.append((f, len(res.itemsets), round(wall * 1e3, 2)))
        q_s = [timed(lambda: dm.mine(spec.with_(min_sup=0.15)))[1] for _ in range(3)]
        waves = dm._miner.stage_counters["waves"] - w0
        ws = read(dm)
        b1 = sum(st["launches"]["nlist_intersect"] for st in ws.values()) - b1_0
        b2 = sum(st["launches"]["nlist_intersect_es"] for st in ws.values())
        if counting and (b1 != waves * len(dm._segments) or b2):
            raise AssertionError(f"{waves} waves over {len(dm._segments)} segments: B1 {b1}, B2 {b2}")
        smi_apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout if counting else ""
        used = dict(line.split(", ", 1) for line in smi_apps.strip().splitlines() if ", " in line)
        mem = {w.wid: used.get(str(w.pid), "not measured (pid not listed by nvidia-smi)")
               for w in dm._live()}
        mem["both workers (device memory.used after the sweep minus before the spawn)"] = (
            f"{used_before} -> {smi_used()}")
        # dispatch to reply consumed: with pipelined waves it also holds the
        # coordinator's planning of the next wave. p50 as the histogram's
        # estimate and its factor-2 bucket
        tel = eng.telemetry.snapshot()["histograms"]
        rpc = {k.split(".")[2]: (round(v["p50_s"] * 1e3, 3), [
            round(x * 1e3, 3) for x in eng.telemetry.histogram(k).quantile_bounds(0.5)])
            for k, v in tel.items() if k.startswith("dist.mushroom.worker")}
        log(f"dist mushroom/4 over 2 workers: append walls {[round(w * 1e3, 2) for w in walls]}ms, "
            f"segments on workers {sorted((m.seg_id, m.worker) for m in dm._segments.values())}; "
            f"sweep (min_sup, itemsets, ms) {sweep} == host mine_prepost == phase 8a's 4-batch "
            f"stream == phase 4's one-shot (0.15); query@0.15 {[round(t * 1e3, 2) for t in q_s]}ms "
            f"against phase 8a's single-process 4-segment query "
            f"{[round(t * 1e3, 2) for t in stream4['query_s']]}ms; {waves} waves x "
            f"{len(dm._segments)} segments = B1 {b1} launches in the workers, B2 {b2}; wave_rpc_s "
            f"p50 per worker (estimate, [bucket]) {rpc}ms; device memory per worker (nvidia-smi) {mem} [{smi}]")

        # 10b. pumsb at its full width: the C block of each append rides the
        # wire. No snapshot store, as in phase 8b: the appends spill nothing
        prows, pn = data["pumsb"]
        pspec = spec.with_(max_f1=8192)
        pdm = open_db("pumsb", pn, pspec, engine=MiningEngine(device=dev))
        pwalls, pbytes, rpc_s = [], [], []
        prep_on = pdm._prep_on

        def timed_prep(w, m):  # the prep RPC: the worker's build and the reply
            t0 = time.perf_counter()
            out = prep_on(w, m)
            rpc_s.append(time.perf_counter() - t0)
            return out

        pdm._prep_on = timed_prep
        for b in np.array_split(prows, 4):
            wire[0] = 0
            st, wall = timed(lambda b=b: pdm.append(b))
            pwalls.append(wall)
            pbytes.append(wire[0])
        pres, pwall = timed(lambda: pdm.mine(pspec.with_(min_sup=0.15)))
        want = host_answer(data, host, "pumsb", pres.min_count)
        if pres.itemsets != want:
            raise AssertionError(f"distributed pumsb: {len(pres.itemsets)} itemsets vs host {len(want)}")
        ws = read(pdm)
        if counting and any(st["launches"]["cooccur"] != st["stats"]["seg_prepares"]
                            for st in ws.values()):
            raise AssertionError(f"pumsb workers: {ws}")
        log(f"dist pumsb/4 (max_f1=8192): segments K_s "
            f"{[len(m.local_items) for m in pdm._segments.values()]}, reply bytes per append "
            f"(the C block, K_s^2 int32, over loopback) {pbytes}, append walls "
            f"{[round(w * 1e3, 1) for w in pwalls]}ms, of which the prep RPC (the worker's build, "
            f"the reply pickled and read) {[round(t * 1e3, 1) for t in rpc_s]}ms and the "
            f"coordinator's fold of C the rest; query@0.15 {pwall * 1e3:.1f}ms, "
            f"{len(pres.itemsets)} itemsets == host mine_prepost [{smi}]")
        pdm.close()

        # 10c. failures: kill the lower worker; the sweep is unchanged and
        # every re-placed segment is a snapshot restore
        victim = min(w.wid for w in dm._live())
        read(dm)
        dm.kill_worker(victim)
        for f, n, _ in sweep:
            res, wall = timed(lambda f=f: dm.mine(spec.with_(min_sup=f)))
            if res.itemsets != stream4["answers"][f]:
                raise AssertionError(f"after the kill at {f}: {len(res.itemsets)} itemsets vs {n}")
        st = dm.stats
        if st["reassign_rebuilds"] or not st["reassign_snapshot_restores"] or st["workers_lost"] != 1:
            raise AssertionError(f"failover: {st}")
        read(dm)
        log(f"dist kill worker {victim}: sweep bit-identical on 1 live worker, failovers "
            f"{st['failovers']}, reassigned {st['reassigned_segments']}, snapshot restores "
            f"{st['reassign_snapshot_restores']}, rebuilds {st['reassign_rebuilds']}; "
            f"query@0.15 after it {wall * 1e3:.2f}ms [{smi}]")
        dm.close()

        # a second database with a restart budget: a death armed one wave
        # into a query is replayed, and the worker respawned
        rdm = open_db("respawn", n_items, spec, restart_budget=1)
        for b in batches:
            if rdm.append(b)["prep_source"] != "snapshot":
                raise AssertionError("the second database rebuilt a segment the store holds")
        victim = min(m.worker for m in rdm._segments.values())
        read(rdm)
        rdm.inject_fault(victim, "wave", after=1)
        res, wall = timed(lambda: rdm.mine(spec.with_(min_sup=0.15)))
        st = rdm.stats
        if (res.itemsets != stream4["answers"][0.15] or st["respawns"] != 1
                or st["query_retries"] != 1 or st["reassign_rebuilds"] or len(rdm._live()) != 2):
            raise AssertionError(f"fault replay / respawn: {len(res.itemsets)} itemsets, stats {st}")
        fresh = max(w.wid for w in rdm._live())
        ws = read(rdm)
        if counting and ws[fresh]["launches"]["cooccur"]:
            raise AssertionError(f"the respawned worker rebuilt a segment: {ws[fresh]}")
        log(f"dist fault armed on worker {victim} one wave into a query: replayed bit-identically "
            f"({wall * 1e3:.1f}ms with the failover), query_retries {st['query_retries']}, respawned "
            f"worker {fresh} on {rdm._workers[fresh].device} (spawn-to-hello "
            f"{rdm._workers[fresh].hello_s:.2f}s) holding segments "
            f"{ws[fresh]['segments']} restored from snapshots, rebuilds {st['reassign_rebuilds']} "
            f"[{smi}]")

        # 10d. the service: stream Futures against the distributed database
        with MiningService(engine=eng) as svc:
            q = spec.with_(min_sup=0.15)
            before = svc.submit_stream(q, stream="respawn")
            app = svc.append(batches[0], stream="respawn")
            after = svc.submit_stream(q, stream="respawn")
            r0, a, r1 = before.result(600), app.result(600), after.result(600)
            snap = svc.stats()
            if (r0.itemsets != stream4["answers"][0.15] or r1.n_rows != len(plus)
                    or r1.itemsets != want_plus or a["total_rows"] != len(plus)
                    or snap["counters"]["respawns"] != rdm.stats["respawns"]
                    or rdm.stats["respawns"] != 1):
                raise AssertionError(f"service: {r0.n_rows}/{r1.n_rows} rows, counters "
                                     f"{snap['counters']}")
        read(rdm)
        log(f"dist service: submit_stream, append, submit_stream Futures in arrival order; "
            f"{r1.n_rows} rows after the append, {len(r1.itemsets)} itemsets == a one-shot mine; "
            f"stats()['counters']['respawns'] {snap['counters']['respawns']} == the coordinator's")
        rdm.close()
    finally:
        protocol._recv_exact = recv_exact
        for d in dbs:
            d.close()
        import shutil

        shutil.rmtree(snap_dir, ignore_errors=True)
    left = [p for p in multiprocessing.active_children() if p.name.startswith("mine-worker")]
    if left:
        raise AssertionError(f"worker processes outlived their databases: {left}")
    mine = K.launches()
    if any(mine.values()):
        raise AssertionError(f"the coordinator launched kernels: {mine}")
    total = {k: sum(v[k] for v in seen.values()) for k in mine}
    log(f"dist spawn-to-hello per worker {json.dumps({f'{n}/{w}': round(t, 2) for (n, w), t in hellos.items()})}s; "
        f"workers' launches {json.dumps(total)} [{smi}]")
    if counting and not (total["nlist_intersect"] and total["cooccur"]):
        raise AssertionError(f"a kernel of the distributed path was not launched in phase 10: {total}")
    return total


# ------------------------------------------------------ phase 11: LM serving
# fp32 parameters over 40 GB whole: served at full width with 2 layers
LM_CUT = ("internlm2_20b", "internvl2_26b", "phi3_5_moe")
# decode against a full prefill, at each family's fewest layers (see
# lm_consistency): float32 at the reference's own rtol = atol; bfloat16 as a
# share of the largest |logit|
LM_TOL_FP32 = 2e-3
LM_TOL_BF16 = 0.25
LM_TOL_CARD_CPU = 1e-3  # card against CPU, float32: a share of max(1, max|logit|)
LM_BUDGET_S = 120.0


def lm_requests(cfg, n: int = 4, max_new: int = 16):
    """``launch.serve``'s request set: n prompts of 4-23 tokens."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    return [Request(rng.integers(1, cfg.vocab_size, size=rng.integers(4, 24)).astype(np.int32),
                    max_new=max_new) for _ in range(n)]


def lm_fewest_layers(cfg):
    """The fewest layers the family's stacking allows (one xLSTM or Zamba2
    group, else one layer and for encdec one encoder layer)."""
    n = {"ssm": cfg.slstm_every, "hybrid": cfg.attn_every}.get(cfg.family, 1)
    return dataclasses.replace(cfg, n_layers=n, encoder_layers=min(cfg.encoder_layers, 1))


def lm_sub_model(cfg, state: dict, dev, **changes):
    """The model of ``cfg`` with ``changes`` (fewer layers, another compute
    dtype) over the leading layers of ``state``, sharing its tensors."""
    from repro_torch.models.registry import build_model, load_model

    cut = dataclasses.replace(cfg, **changes)
    return cut, load_model(cut, {k: state[k] for k in build_model(cut).state_dict()}, dev)


def lm_consistency(cfg, model, dev) -> str:
    """The reference's ``test_decode_consistency_with_full_forward``: logits
    of a prefill of S tokens against a prefill of S-1 then one decode step
    (batch 2, S = 24 after the VLM's patches), float32 within the
    reference's ``allclose(rtol=atol=2e-3)``, bfloat16 within LM_TOL_BF16 of
    the largest |logit|. Raises past the tolerance; -> "dtype max|diff|/max|logit|".
    MoE archs with ``capacity_factor = E / k``: no pair dropped, since a
    dropped pair changes its token's output by design."""
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import cache_specs_for, materialize_batch

    if cfg.n_experts:
        model.cfg = cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    S = 24 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    batch = materialize_batch(cfg, "train_4k", S, 2, device=dev)
    tokens = batch["tokens"]
    n = tokens.shape[1] - 1
    specs = cache_specs_for(cfg, "decode_32k", seq=S + 8, batch=2)
    with torch.inference_mode():
        full, _ = model.prefill({**batch, "tokens": tokens[:, :n]}, init_params(specs, device=dev))
        _, cache = model.prefill({**batch, "tokens": tokens[:, :n - 1]}, init_params(specs, device=dev))
        step, _ = model.decode({"token": tokens[:, n - 1:n], "pos": S - 1}, cache)
    full, step = full[:, 0].float(), step[:, 0].float()
    err, scale = float((step - full).abs().max()), float(full.abs().max())
    if cfg.dtype == "bfloat16":
        ok = err <= LM_TOL_BF16 * scale
    else:
        ok = bool(torch.isclose(step, full, rtol=LM_TOL_FP32, atol=LM_TOL_FP32).all())
    if not (ok and math.isfinite(err)):
        raise AssertionError(f"{cfg.name} {cfg.dtype} at {cfg.n_layers} layers: decode against full "
                             f"prefill, max abs error {err} (max|logit| {scale})")
    return f"{cfg.dtype} {err:.4f}/{scale:.2f}"


def lm_card_vs_cpu(arch: str, dev) -> str:
    """11b: the fewest-layer full-width model in float32 with one set of
    weights (drawn on the CPU, copied to the card): prefill and 4 decode
    steps of the serve request set, logits within LM_TOL_CARD_CPU and the
    greedy tokens equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import build_model, cache_specs_for, load_model

    cfg = dataclasses.replace(lm_fewest_layers(get_config(arch)), dtype="float32")
    state = params_from_reference(cfg, init_params(build_model(cfg).param_specs(),
                                                   torch.Generator().manual_seed(0)))
    reqs = lm_requests(cfg)
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((4, plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    runs = {}
    for where in ("cpu", dev):
        model = load_model(cfg, state, where)
        batch = {"tokens": torch.from_numpy(toks).to(where)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((4, max(plen // 4, 1), cfg.d_model), device=where)
        cache = init_params(cache_specs_for(cfg, "decode_32k", seq=128, batch=4), device=where)
        out = []
        with torch.inference_mode():
            logits, cache = model.prefill(batch, cache)
            for step in range(5):
                nxt = logits[:, -1].argmax(-1).to(torch.int32)
                out.append((logits[:, -1].float().cpu(), nxt.cpu()))
                if step < 4:
                    logits, cache = model.decode({"token": nxt[:, None], "pos": plen + step}, cache)
        runs[where] = out
        del model, cache
    errs = []
    for i, ((lc, tc), (lg, tg)) in enumerate(zip(runs["cpu"], runs[dev])):
        err, scale = float((lg - lc).abs().max()), max(1.0, float(lc.abs().max()))
        errs.append(err / scale)
        if err > LM_TOL_CARD_CPU * scale or not torch.equal(tc, tg):
            raise AssertionError(f"{arch} card against CPU, step {i}: max abs error {err} (scale {scale}), "
                                 f"tokens {tg.tolist()} vs {tc.tolist()}")
    return (f"{arch} ({cfg.n_layers} layers{', 1 encoder layer' if cfg.encoder_layers else ''}): "
            f"prefill + 4 decode steps, max error / scale {max(errs):.2e}, tokens equal")


def lm_phase(smi: str, dev="cuda", reduced: bool = False) -> dict:
    """Phase 11: the LM scaffold's serving path (see the module docstring).
    ``reduced=True, dev="cpu"`` rehearses it on the CPU with the reduced
    configs. -> tinyllama's numbers (11c)."""
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.launch import roofline
    from repro_torch.models.common import init_params, n_params
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import Engine

    on_card = torch.device(dev).type == "cuda"
    if on_card and (torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("float32 matmuls would round through TF32")
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def build(arch):
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        elif arch in LM_CUT:
            cfg = dataclasses.replace(cfg, n_layers=2)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = params_from_reference(cfg, init_params(build_model(cfg).param_specs(), gen))
        return cfg, state

    # 11a: every arch in its config dtype through the Engine
    for arch in ARCH_IDS:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, state = build(arch)
        eng = Engine(cfg, state, batch_size=4, max_seq=128, device=dev)
        sync()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        done = eng.generate(lm_requests(cfg))
        sync()
        wall = time.perf_counter() - t0
        outs = [r.out for r in done]
        if not all(len(o) == 16 and all(0 <= t < cfg.padded_vocab for t in o) for o in outs):
            raise AssertionError(f"{arch}: tokens {outs}")
        if [r.out for r in eng.generate(lm_requests(cfg))] != outs:
            raise AssertionError(f"{arch}: a second generate gave other tokens")
        peak = torch.cuda.max_memory_allocated() / MB if on_card else float("nan")
        del eng
        few = lm_fewest_layers(cfg) if not reduced else cfg
        checks = []
        for dtype in sorted({cfg.dtype, "float32"}):
            sub, model = lm_sub_model(cfg, state, dev, n_layers=few.n_layers,
                                      encoder_layers=few.encoder_layers, dtype=dtype)
            checks.append(lm_consistency(sub, model, dev))
            del model
        cut = f"; cut to {cfg.n_layers} layers at full width" if arch in LM_CUT and not reduced else ""
        log(f"lm {arch} ({cfg.family}, {n_params(build_model(cfg).param_specs()) / 1e9:.3f}B params, "
            f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}{cut}): init {t_init:.2f}s, "
            f"generate 4x16 {wall:.2f}s, peak {peak:.1f} MiB; tokens in [0, {cfg.padded_vocab}), "
            f"repeatable; decode vs full prefill at {few.n_layers} layers (max|diff|/max|logit|): "
            f"{', '.join(checks)}; req0 {outs[0][:8]}")
        del state
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # 11b: card against CPU in float32
    if not reduced:
        for arch in ("tinyllama_1_1b", "granite_moe", "zamba2_2_7b", "seamless_m4t_v2"):
            log(f"lm card vs cpu: {lm_card_vs_cpu(arch, dev)}")
            gc.collect()

    # 11c: tinyllama at its full config, bfloat16
    cfg, state = build("tinyllama_1_1b")
    eng = Engine(cfg, state, batch_size=4, max_seq=128, device=dev)
    eng.generate(lm_requests(cfg))  # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.generate(lm_requests(cfg))
    sync()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / MB if on_card else float("nan")
    reqs = lm_requests(cfg)
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((4, plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    pre_ms, dec_ms = [], []
    with torch.inference_mode():
        for _ in range(5):
            cache = eng._fresh_cache()
            sync()
            t0 = time.perf_counter()
            logits, cache = eng.model.prefill(batch, cache)
            sync()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        for pos in range(plen, plen + 16):
            t0 = time.perf_counter()
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            logits, cache = eng.model.decode({"token": nxt[:, None], "pos": pos}, cache)
            nxt.cpu()
            sync()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
        busy = "not measured"
        if on_card:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for pos in range(plen + 16, plen + 24):
                    logits, cache = eng.model.decode({"token": nxt[:, None], "pos": pos}, cache)
                    logits[:, -1].argmax(-1).cpu()
                wall_ms = (time.perf_counter() - t0) * 1e3
            tl = device_timeline(prof)
            ops = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA and not ev.name.startswith("Activity Buffer"):
                    ms, k = ops.get(ev.name, (0.0, 0))
                    ops[ev.name] = (ms + (ev.time_range.end - ev.time_range.start) / 1e3, k + 1)
            top = "; ".join(f"{k[:60]} x{c / 8:g} {ms / 8:.3f}ms"
                            for k, (ms, c) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:5])
            busy = (f"under the profiler: device busy {tl['busy_ms'] / 8:.3f} ms a step of "
                    f"{wall_ms / 8:.3f}, idle share {1 - tl['busy_ms'] / wall_ms:.3f}, "
                    f"{tl['device_events'] / 8:g} device ops a step; top a step: {top}"
                    if tl["device_events"] else "device time not measured (the profiler recorded none)")
    n = n_params(build_model(cfg).param_specs())
    kv_bytes = sum(t.numel() * t.element_size() for t in (cache["kv"]["k"], cache["kv"]["v"], cache["kv"]["pos"]))
    bound_ms = (n * 4 + kv_bytes) / roofline.HBM_BYTES_PER_S * 1e3
    med = float(np.median(dec_ms[2:]))
    nums = dict(arch="tinyllama_1_1b", batch=4, max_seq=128, prompt_len=plen, prefill_ms=float(np.median(pre_ms)),
                decode_ms_per_step=med, decode_tokens_per_s=4 * 1e3 / med,
                generate_tokens_per_s=4 * 16 / gen_s, peak_mib=peak, param_bytes=n * 4, kv_bytes=kv_bytes,
                decode_bound_ms=bound_ms)
    log(f"lm tinyllama_1_1b ({cfg.dtype} compute, float32 parameters): {json.dumps(nums)}; "
        f"decode steps ms {[round(t, 3) for t in dec_ms]}; {busy} [{smi}]")
    del eng, state, cache, logits
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    log(f"lm: phase 11 took {took:.1f}s")
    if on_card and took > LM_BUDGET_S:
        raise AssertionError(f"phase 11 took {took:.1f}s, over its {LM_BUDGET_S:.0f}s budget")
    return nums


# ----------------------------------------------------- phase 12: LM training
# card against CPU, float32: a share of max(1, max|CPU leaf|); every family
# 1e-3, except the xLSTM. Its mLSTM chunks amplify float32 rounding most, and
# the card's and the CPU's roundings differ: at lm_fewest_layers its float32
# gradients lie up to 7.25e-4 of the scale from a float64 evaluation of the
# same weights and batch on the card, the CPU's 4.65e-4, on the same leaf
# (groups.0.mlstm.1.w_if) and on opposite sides, so the two differ by up to
# their sum (1.19e-3 measured). Both float64 evaluations agree within 8e-13,
# and running only the mLSTM blocks in float64 brings the card within 2.3e-5
# (lm_train_f64_gaps). So the xLSTM is gated on each side's own distance from
# float64, LM_TRAIN_F64_TOL (1.5e-3, which tests/test_torch_train_grads.py::
# test_float32_gradients_near_float64 holds the CPU to), and card against CPU
# within the sum of two such distances, 3e-3
LM_TRAIN_TOL = {"ssm": 3e-3}
LM_TRAIN_TOL_DEFAULT = 1e-3
LM_TRAIN_F64_TOL = {"ssm": 1.5e-3}
LM_TRAIN_BUDGET_S = 180.0


def train_bound(cfg, batch: int, seq: int) -> dict:
    """The least time a train step of ``cfg`` could take on the card: the
    larger of its FLOPs at the bfloat16 peak (6 × the parameters that
    multiply × tokens, plus the attention's score and value products,
    forward and backward) and its bytes at the HBM rate (the step's inputs
    and outputs are p, m and v in float32: each read once and written
    once)."""
    from repro_torch.launch.roofline import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
    from repro_torch.models.common import n_params
    from repro_torch.models.registry import build_model

    n = n_params(build_model(cfg).param_specs())
    dense = n - cfg.padded_vocab * cfg.d_model  # the token embedding is a gather
    tokens = batch * seq
    attn = 3 * 4 * batch * seq * seq * cfg.n_heads * cfg.resolved_head_dim * cfg.n_layers
    flops = 6 * dense * tokens + attn
    nbytes = 24 * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(params=n, flops=flops, bytes=nbytes, flops_ms=t_ops, bytes_ms=t_bytes,
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes")


def lm_train_grads(cfg, state: dict, dev) -> tuple:
    """Loss and gradients (name -> tensor) of one 2 × 24-token batch, the
    model holding ``state`` on ``dev``."""
    from repro_torch.models.registry import load_model, materialize_batch
    from repro_torch.training.step import deterministic

    model = load_model(cfg, state, dev)
    leaves = dict(model.named_parameters())
    S = 24 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    with deterministic():
        loss = model.loss(materialize_batch(cfg, "train_4k", S, 2, device=dev))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


@contextlib.contextmanager
def float64_widened():
    """Every float32 step of the LM code in float64 while it is open:
    ``.float()``, float32 allocations by ``torch.zeros``/``torch.full`` and
    the xLSTM's fresh cache states widened (the patches of
    ``tests/test_torch_train_grads.py``'s ``_float64_grads``; the script
    imports no test file)."""
    import repro_torch.models.ssm_models as ssm_models

    def widen(fn):
        def wrapped(*args, **kw):
            if kw.get("dtype") == torch.float32:
                kw["dtype"] = torch.float64
            return fn(*args, **kw)
        return wrapped

    real = (torch.Tensor.float, torch.zeros, torch.full, ssm_models.init_params)
    real_init = real[3]
    torch.Tensor.float = lambda self: self.double()
    torch.zeros, torch.full = widen(real[1]), widen(real[2])
    ssm_models.init_params = lambda *a, **kw: {
        k: {n: t.double() if t.dtype == torch.float32 else t for n, t in v.items()}
        for k, v in real_init(*a, **kw).items()}
    try:
        yield
    finally:
        torch.Tensor.float, torch.zeros, torch.full, ssm_models.init_params = real


def lm_float64_grads(cfg, state: dict, dev) -> dict:
    """``lm_train_grads``'s gradients with every float32 step in float64 on
    ``dev``: the evaluation float32 rounding is measured against."""
    from repro_torch.models.registry import build_model, materialize_batch

    S = 24 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    batch = materialize_batch(cfg, "train_4k", S, 2, device=dev)
    with float64_widened():
        model = build_model(dataclasses.replace(cfg, dtype="float64"))
        model.load_state_dict({k: v.to(dev, torch.float64) for k, v in state.items()}, strict=True, assign=True)
        leaves = dict(model.named_parameters())
        loss = model.loss({k: v.double() if v.is_floating_point() else v for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return dict(zip(leaves, grads))


def leaf_gaps(grads: dict, truth: dict) -> dict:
    """Each leaf's largest error against ``truth``, as a share of max(1, the
    truth's largest |value|); compared in float64 on the truth's device."""
    out = {}
    for k, t in truth.items():
        g = grads[k].to(t.device, torch.float64)
        out[k] = float((g - t.double()).abs().max()) / max(1.0, float(t.abs().max()))
    return out


@contextlib.contextmanager
def block_widened(name: str):
    """``repro_torch.models.ssm.<name>`` (``slstm`` or ``mlstm``) run in
    float64 inside an otherwise float32 model: its parameters, input and
    recurrent state widened on the way in, its output narrowed on the way
    out, its backward in float64 too. Only that block's rounding leaves."""
    from repro_torch.models import ssm

    real = getattr(ssm, name)

    def run(p, x, cfg, state=None, **kw):
        wide = {k: v.double() for k, v in p.named_parameters()}
        st = {k: v.double() for k, v in state.items()} if state is not None else None
        with float64_widened():
            y, new = real(wide, x.double(), cfg, state=st, **kw)
        return y.float(), new

    setattr(ssm, name, run)
    try:
        yield
    finally:
        setattr(ssm, name, real)


def lm_train_f64_gaps(cfg, state: dict, g_cpu: dict, g_card: dict, dev) -> dict:
    """How far the card's and the CPU's float32 gradients lie from a float64
    evaluation of the same weights and batch (on the card; the CPU's float64
    evaluation beside it shows whether the two devices compute the same
    function), the five worst leaves, and what moves the card's distance:
    the group recompute turned off, and the sLSTM or the mLSTM blocks alone
    run in float64."""
    import repro_torch.models.layers as ll

    t64 = lm_float64_grads(cfg, state, dev)
    card, cpu = leaf_gaps(g_card, t64), leaf_gaps(g_cpu, t64)
    f64_devices = max(leaf_gaps(lm_float64_grads(cfg, state, "cpu"), t64).values())
    worst = sorted(card, key=lambda k: -card[k])[:5]
    real_remat = ll.remat
    ll.remat = lambda fn, *args: fn(*args)
    try:
        _, g_flat = lm_train_grads(cfg, state, dev)
    finally:
        ll.remat = real_remat
    widened = {}
    for name in ("slstm", "mlstm"):
        with block_widened(name):
            _, g = lm_train_grads(cfg, state, dev)
        gaps = leaf_gaps(g, t64)
        widened[name] = dict(max=max(gaps.values()), at_worst=gaps[worst[0]])
    return dict(card=max(card.values()), cpu=max(cpu.values()), float64_card_vs_cpu=f64_devices,
                worst=[(k, card[k], cpu[k]) for k in worst],
                recompute_changes_no_bit=all(torch.equal(g_flat[k], g_card[k]) for k in g_card),
                block_in_float64=widened)


def lm_train_card_vs_cpu(arch: str, dev, reduced: bool = False) -> str:
    """12c for one arch (see the module docstring); ``reduced=True``
    rehearses it on the reduced config. -> a log fragment."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import build_model, materialize_batch
    from repro_torch.training.step import TrainConfig, make_train_state, make_train_step

    full = get_config(arch).reduced() if reduced else lm_fewest_layers(get_config(arch))
    on_card = torch.device(dev).type == "cuda"
    cfg = dataclasses.replace(full, dtype="float32")
    t0 = time.perf_counter()
    state = params_from_reference(cfg, init_params(build_model(cfg).param_specs(), torch.Generator().manual_seed(0)))
    n = sum(t.numel() for t in state.values())
    lc, gc_ = lm_train_grads(cfg, state, "cpu")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg, gg = lm_train_grads(cfg, state, dev)
    if on_card:
        torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    f64 = ""
    if cfg.family in LM_TRAIN_F64_TOL:
        gaps = lm_train_f64_gaps(cfg, state, gc_, gg, dev)
        f64 = (f"; float32 against float64 (largest error / scale): card {gaps['card']:.3e}, cpu {gaps['cpu']:.3e} "
               f"(tolerance {LM_TRAIN_F64_TOL[cfg.family]:g} each); float64 card against cpu "
               f"{gaps['float64_card_vs_cpu']:.1e}; worst leaves (card, cpu): "
               + ", ".join(f"{k} {a:.3e} {b:.3e}" for k, a, b in gaps["worst"])
               + f"; the group recompute off changes no bit: {gaps['recompute_changes_no_bit']}; card with only "
               + ", ".join(f"the {n} blocks in float64 {v['max']:.3e} (worst leaf {v['at_worst']:.3e})"
                           for n, v in gaps["block_in_float64"].items()))
        if not (gaps["card"] <= LM_TRAIN_F64_TOL[cfg.family] and gaps["cpu"] <= LM_TRAIN_F64_TOL[cfg.family]
                and gaps["recompute_changes_no_bit"]):
            raise AssertionError(f"{arch}: gradients against float64{f64}")
    worst, where = 0.0, ""
    tol = LM_TRAIN_TOL.get(cfg.family, LM_TRAIN_TOL_DEFAULT)
    scale = max(1.0, abs(float(lc)))
    if not (math.isfinite(float(lg)) and abs(float(lg) - float(lc)) <= tol * scale):
        raise AssertionError(f"{arch}: loss on the card {float(lg)} against {float(lc)} on the CPU")
    for k in list(gc_):
        g = gc_.pop(k).to(dev)  # compared on the card: the host's passes over 9 GB cost seconds
        scale = max(1.0, float(g.abs().max()))
        err = float((gg[k] - g).abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"{arch}: gradient {k} on the card against the CPU: max abs error {err} "
                                 f"(scale {scale})")
        if err / scale > worst:
            worst, where = err / scale, k
    del gg, gc_, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # one train step in the config's own dtype on the card
    model = build_model(full)
    tstate = make_train_state(model, torch.Generator(device=dev).manual_seed(0), TrainConfig())
    S = 24 + (full.frontend_tokens if full.family == "vlm" else 0)
    tstate, m = make_train_step(model, TrainConfig())(tstate, materialize_batch(full, "train_4k", S, 2, device=dev))
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gn)):
        raise AssertionError(f"{arch}: {full.dtype} train step loss {loss}, grad norm {gn}")
    peak = torch.cuda.max_memory_allocated() / MB if on_card else float("nan")
    del tstate, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return (f"{arch} ({cfg.n_layers} layers{', 1 encoder layer' if cfg.encoder_layers else ''}, "
            f"{n / 1e9:.3f}B params): float32 loss {float(lc):.5f} card {float(lg):.5f}, every gradient leaf "
            f"within {worst:.2e} of its scale (worst {where}; tolerance {tol:g}); cpu {t_cpu:.1f}s, "
            f"card {t_card:.1f}s{f64}; "
            f"{full.dtype} step loss {loss:.4f} grad norm {gn:.4f}, peak {peak:.1f} MiB")


def lm_train_phase(smi: str, K, dev="cuda", reduced: bool = False) -> dict:
    """Phase 12: the LM scaffold's training path (see the module docstring).
    ``reduced=True, dev="cpu"`` rehearses it on the CPU with the reduced
    configs (the profiler's device numbers are then absent). -> 12a's
    numbers."""
    import repro_torch.training.step as step_mod
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.data import corpus
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build_model
    from repro_torch.training.optim import OptConfig, adamw_update
    from repro_torch.training.step import TrainConfig, make_train_state, make_train_step

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    K.reset_launches()

    # 12a: tinyllama's full config, timed
    cfg = get_config("tinyllama_1_1b").reduced() if reduced else get_config("tinyllama_1_1b")
    model = build_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=100))
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(42), tc)
    sync()
    t_init = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size() for part in (state["params"], state["opt"]["m"], state["opt"]["v"])
                      for t in part.values())
    probe = state["params"]["layers.0.attn.wq"][0, 0, :8].clone()
    step = make_train_step(model, tc)
    toks = corpus.token_stream(2_000_000, cfg.vocab_size, seed=0)
    batches = corpus.batches(toks, 8, 128, seed=0)

    def run(n):
        nonlocal state
        ms, losses = [], []
        for _ in range(n):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # the Trainer's sync a step
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, losses

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    warm_ms, warm_losses = run(2)
    step_ms, losses = run(6)
    peak = torch.cuda.max_memory_allocated() / MB if on_card else float("nan")
    if not all(math.isfinite(x) for x in warm_losses + losses):
        raise AssertionError(f"12a: losses {warm_losses + losses}")
    if torch.equal(state["params"]["layers.0.attn.wq"][0, 0, :8], probe) or int(state["opt"]["step"]) != 8:
        raise AssertionError("12a: the parameters did not move in 8 steps")
    with contextlib.ExitStack() as stack:  # the deterministic context's cost
        real = step_mod.deterministic
        step_mod.deterministic = contextlib.nullcontext
        stack.callback(setattr, step_mod, "deterministic", real)
        nodet_ms, _ = run(3)
    # the step's two halves on the host clock: loss and gradients, then AdamW
    split = {"loss_grads_ms": [], "adamw_ms": []}
    for _ in range(2):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
        leaves = dict(model.named_parameters())  # the step has bound state["params"]
        sync()
        t0 = time.perf_counter()
        with step_mod.deterministic():
            loss = model.loss(batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        sync()
        t1 = time.perf_counter()
        _, state["opt"], _ = adamw_update(tc.opt, state["params"], grads, state["opt"])
        sync()
        split["loss_grads_ms"].append((t1 - t0) * 1e3)
        split["adamw_ms"].append((time.perf_counter() - t1) * 1e3)
        del grads, loss
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    tl = device_timeline(prof) if on_card else {"device_events": 0}
    med = float(np.median(step_ms))
    prof_txt = "device time not measured (the profiler recorded none)"
    if tl["device_events"]:
        rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count) for e in prof.key_averages()]
        top = "; ".join(f"{k} {t:.2f}ms x{c}" for k, t, c in sorted(rows, key=lambda r: -r[1])[:8] if t > 0)
        prof_txt = (f"device busy {tl['busy_ms']:.2f} ms, {tl['device_events']} device ops; idle share "
                    f"{1 - tl['busy_ms'] / wall_ms:.3f} of the profiled step ({wall_ms:.2f} ms), "
                    f"{1 - tl['busy_ms'] / med:.3f} of the unprofiled median; device time by op: {top}")
    bnd = train_bound(cfg, 8, 128)  # the bound of the config run here
    nums = dict(arch="tinyllama_1_1b", batch=8, seq=128, tokens_per_step=1024, init_s=t_init,
                step_ms=med, tokens_per_s=1024 * 1e3 / med, peak_mib=peak, state_bytes=state_bytes,
                nondeterministic_step_ms=float(np.median(nodet_ms)),
                loss_grads_ms=float(np.median(split["loss_grads_ms"])), adamw_ms=float(np.median(split["adamw_ms"])),
                device_busy_ms=tl["busy_ms"] if tl["device_events"] else None,
                idle_share=1 - tl["busy_ms"] / med if tl["device_events"] else None,
                device_ops=tl["device_events"], **bnd)
    log(f"lm train tinyllama_1_1b ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype} compute, float32 "
        f"parameters and moments; no checkpoint: "
        f"{state_bytes / 1e9:.1f} GB a save): {json.dumps(nums)}; warm-up ms {[round(t, 2) for t in warm_ms]}, "
        f"steps ms {[round(t, 2) for t in step_ms]}, without deterministic algorithms "
        f"{[round(t, 2) for t in nodet_ms]}; loss and gradients / AdamW ms {split}; "
        f"losses {[round(x, 4) for x in warm_losses + losses]}; "
        f"one step under torch.profiler: {prof_txt} [{smi}]")
    del state, step, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 12b: the entry point, a failure and a restart, against an uninterrupted run
    t0 = time.perf_counter()
    finals = []
    with tempfile.TemporaryDirectory() as d:
        for name, extra in (("fail", ["--inject-failure-at", "13"]), ("whole", [])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                hist = launch_train.main(["--arch", "tinyllama_1_1b", "--reduced", "--steps", "24", "--ckpt-every",
                                          "8", "--ckpt-dir", str(Path(d) / name), "--device", dev] + extra)
            cm = CheckpointManager(str(Path(d) / name))
            if cm.list_steps() != [7, 15, 23]:
                raise AssertionError(f"12b {name}: checkpoints {cm.list_steps()}")
            finals.append((cm.restore(23)[0], hist, out.getvalue().splitlines()[0]))
    (a, hist_a, line_a), (b, _, line_b) = finals
    diff = [k for k in b["params"] if not torch.equal(a["params"][k], b["params"][k])]
    if diff or not torch.equal(a["opt"]["step"], b["opt"]["step"]):
        raise AssertionError(f"12b: the restarted run's parameters differ from the uninterrupted run's: {diff[:5]}")
    if [h["step"] for h in hist_a] != list(range(13)) + list(range(8, 24)):
        raise AssertionError(f"12b: steps run {[h['step'] for h in hist_a]}")
    log(f"lm train 12b (launch.train --reduced, 24 steps, checkpoints at 7/15/23): failure at step 13, restart "
        f"from step 7's checkpoint; final parameters equal the uninterrupted run's bit for bit "
        f"({len(b['params'])} leaves); '{line_a}' / '{line_b}'; {time.perf_counter() - t0:.1f}s")

    # 12c: every arch, card against CPU
    t0 = time.perf_counter()
    failed = []
    for arch in ARCH_IDS:  # every arch is checked before a failure is raised
        try:
            log(f"lm train card vs cpu: {lm_train_card_vs_cpu(arch, dev, reduced)}")
        except AssertionError as e:
            log(f"lm train card vs cpu: FAILED {e}")
            failed.append(str(e))
    log(f"lm train 12c: {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError(f"12c: {len(failed)} arch(s) failed: {'; '.join(failed)}")

    got = K.launches()
    if any(got.values()):
        raise AssertionError(f"phase 12 launched a kernel of this repo: {got}")
    took = time.perf_counter() - t_phase
    log(f"lm train: phase 12 took {took:.1f}s; kernel launches {json.dumps(got)} (the path has none)")
    if on_card and took > LM_TRAIN_BUDGET_S:
        raise AssertionError(f"phase 12 took {took:.1f}s, over its {LM_TRAIN_BUDGET_S:.0f}s budget")
    return nums


# ------------------------------------------- phase 13: LM training over a mesh
LM_MESH_BUDGET_S = 120.0
LM_MESH_TOL = 1e-5  # 13b/13c: a share of max(1, max|expected|)


def sharded_equal(whole: torch.Tensor, held) -> bool:
    """``held`` (a ``Sharded`` moment) equal to ``whole`` bit for bit, block
    by block (no gathered copy)."""
    return all(torch.equal(whole[s], held.blocks[c]) for c, s in held.sharding.slices(tuple(whole.shape)).items())


def lm_mesh_phase(smi: str, K, dev="cuda", reduced: bool = False) -> dict:
    """Phase 13: the LM scaffold's training over a mesh (see the module
    docstring). ``reduced=True, dev="cpu"`` rehearses it on the CPU with
    the reduced configs. -> 13a's numbers."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data import corpus
    from repro_torch.launch.mesh import make_mesh, make_mesh_from_spec
    from repro_torch.models.common import init_params, stack_specs
    from repro_torch.models.moe import moe_ffn, moe_specs
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import positions
    from repro_torch.sharding import MeshRules, Sharded
    from repro_torch.training.compress import compressed_psum
    from repro_torch.training.optim import OptConfig
    from repro_torch.training.pipeline import gpipe_forward
    from repro_torch.training.step import TrainConfig, make_train_state, make_train_step
    from repro_torch.training.trainer import LoopConfig, Trainer

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    if on_card and (torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("float32 matmuls would round through TF32")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def mesh(spec):
        return make_mesh_from_spec(spec, [dev] * math.prod(int(x) for x in spec.split("x")))

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    K.reset_launches()

    # 13a: the ZeRO-1 step on 8x1 against the one-device step, launcher defaults
    cfg = get_config("tinyllama_1_1b").reduced() if reduced else get_config("tinyllama_1_1b")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=min(20, 200 // 10 + 1), total_steps=200))
    rules = MeshRules(mesh("8x1"))
    models = {"one": build_model(cfg), "mesh": build_model(cfg)}  # a model binds one state's tensors
    states = {k: make_train_state(m, torch.Generator(device=dev).manual_seed(42), tc) for k, m in models.items()}
    steps = {"one": make_train_step(models["one"], tc), "mesh": make_train_step(models["mesh"], tc, rules)}
    batches = corpus.batches(corpus.token_stream(2_000_000, cfg.vocab_size, seed=0), 8, 128, seed=0)
    ms = {"one": [], "mesh": []}
    peak = {"one": None, "mesh": None}  # device memory: measured on the card only
    above = {"one": None, "mesh": None}
    losses = []
    for i in range(3):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
        metrics = {}
        for name in (("one", "mesh") if i % 2 == 0 else ("mesh", "one")):
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            states[name], metrics[name] = steps[name](states[name], batch)
            float(metrics[name]["loss"])
            sync()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if on_card:
                peak[name] = max(peak[name] or 0.0, torch.cuda.max_memory_allocated() / MB)
                above[name] = max(above[name] or 0.0, (torch.cuda.max_memory_allocated() - base) / MB)
        one, msh = states["one"], states["mesh"]
        bad = [k for k in ("loss", "grad_norm", "lr") if not torch.equal(metrics["one"][k], metrics["mesh"][k])]
        bad += [f"p {k}" for k, p in one["params"].items() if not torch.equal(p, msh["params"][k])]
        bad += [f"{n} {k}" for n in ("m", "v") for k, t in one["opt"][n].items()
                if not (isinstance(msh["opt"][n][k], Sharded) and sharded_equal(t, msh["opt"][n][k]))]
        if bad:
            raise AssertionError(f"13a step {i}: the 8x1 mesh step differs from the one-device step: {bad[:5]}")
        losses.append(float(metrics["one"]["loss"]))
    moms = [t for n in ("m", "v") for t in states["mesh"]["opt"][n].values()]
    split_bytes = sum(t.nbytes for t in moms if len(t.blocks) > 1)
    nums = dict(arch=cfg.name, mesh="8x1", positions_on=str(dev), batch=8, seq=128, steps=3,
                mesh_step_ms=float(np.median(ms["mesh"])), one_step_ms=float(np.median(ms["one"])),
                mesh_peak_mib=peak["mesh"], one_peak_mib=peak["one"], mesh_above_resident_mib=above["mesh"],
                one_above_resident_mib=above["one"], moment_bytes=sum(t.nbytes for t in moms),
                moment_bytes_split=split_bytes, leaves_split=sum(len(t.blocks) > 1 for t in moms),
                moment_leaves=len(moms), blocks=sum(len(t.blocks) for t in moms))
    log(f"lm mesh 13a (ZeRO-1 on 8x1, every position on {dev}; float32 p, m, v, {cfg.dtype} compute; both states "
        f"resident): {json.dumps(nums)}; steps ms mesh {[round(t, 2) for t in ms['mesh']]} one "
        f"{[round(t, 2) for t in ms['one']]}; losses {[round(x, 4) for x in losses]}; loss, grad norm, p, m "
        f"and v equal bit for bit after each step [{smi}]")
    del states, steps, models, moms, one, msh, batch, metrics
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 13a, elastic: the reduced config on 8x1, checkpointed at step 2, restored
    # onto 2x1 and onto no mesh, against the uninterrupted 8x1 run
    rcfg = get_config("tinyllama_1_1b").reduced()
    rtoks = corpus.token_stream(20_000, rcfg.vocab_size, seed=0)

    def trainer(d, rules):
        return Trainer(build_model(rcfg), TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)),
                       LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(d), log_every=1),
                       lambda: corpus.batches(rtoks, 2, 32, seed=0), rules=rules,
                       device=None if rules is not None else dev)

    with tempfile.TemporaryDirectory() as d:
        whole = trainer(Path(d) / "whole", MeshRules(mesh("8x1")))
        whole.train()
        final, _ = whole.ckpt.restore(5)
        for name, r in (("2x1", MeshRules(mesh("2x1"))), ("no mesh", None)):
            tr = trainer(Path(d) / name.replace(" ", "_"), r)
            st, extra = whole.ckpt.restore(2)
            tr.ckpt.save(2, st, extra)
            if tr.train() != 6 or [h["step"] for h in tr.history] != [3, 4, 5]:
                raise AssertionError(f"13a elastic {name}: ran {[h['step'] for h in tr.history]}")
            got, _ = CheckpointManager(str(Path(d) / name.replace(" ", "_"))).restore(5)
            bad = [f"{part} {k}" for part, a, b in (("p", got["params"], final["params"]),
                                                    ("m", got["opt"]["m"], final["opt"]["m"]),
                                                    ("v", got["opt"]["v"], final["opt"]["v"]))
                   for k in b if not torch.equal(a[k], b[k])]
            if bad:
                raise AssertionError(f"13a elastic {name}: differs from the uninterrupted 8x1 run: {bad[:5]}")
    log("lm mesh 13a elastic (reduced tinyllama): saved on 8x1 at step 2, restored onto 2x1 and onto no mesh, "
        "steps 3-5: p, m and v equal the uninterrupted 8x1 run's bit for bit")

    # 13b: _moe_sharded at full width, card against CPU
    gcfg = get_config("granite_moe").reduced() if reduced else get_config("granite_moe")
    p = init_params(moe_specs(gcfg), torch.Generator().manual_seed(0))
    x = torch.randn((4, 128, gcfg.d_model), generator=torch.Generator().manual_seed(1))
    pd, xd = {k: v.to(dev) for k, v in p.items()}, x.to(dev)
    moe_out = []
    with torch.inference_mode():
        for cf in (1.25, 4.0):
            c = dataclasses.replace(gcfg, capacity_factor=cf)
            for shape in ((1, 1), (2, 1), (1, 2), (2, 2)):
                n = math.prod(shape)
                want, aux_w = moe_ffn(p, x, c, mesh=make_mesh(shape, ("data", "model"), ["cpu"] * n))
                m_dev = make_mesh(shape, ("data", "model"), [dev] * n)
                got, aux_g = moe_ffn(pd, xd, c, mesh=m_dev)
                err = max(float((got.cpu() - want).abs().max()) / max(1.0, float(want.abs().max())),
                          abs(float(aux_g) - float(aux_w)) / max(1.0, abs(float(aux_w))))
                if not err <= LM_MESH_TOL:
                    raise AssertionError(f"13b granite_moe cf {cf} on {shape}: card against CPU {err:.3e}")
                t = []
                for _ in range(5):
                    sync()
                    t0 = time.perf_counter()
                    moe_ffn(pd, xd, c, mesh=m_dev)
                    sync()
                    t.append((time.perf_counter() - t0) * 1e3)
                moe_out.append(f"cf {cf} {shape[0]}x{shape[1]}: {err:.1e}, {float(np.median(t[1:])):.2f} ms")
    log(f"lm mesh 13b (_moe_sharded, {gcfg.name}: d_model {gcfg.d_model}, {gcfg.n_experts} experts top-"
        f"{gcfg.experts_per_token}, float32, batch (4, 128), every position on {dev}): card against CPU "
        f"(max error / scale) and median ms: {'; '.join(moe_out)} [{smi}]")
    del p, x, pd, xd, got, want

    # 13c: GPipe over tinyllama's decoder blocks at full width, float32
    tcfg = dataclasses.replace(cfg, dtype="float32")
    block = build_model(tcfg)
    stacked = init_params(stack_specs(block.layer_specs(), tcfg.n_layers), torch.Generator(device=dev).manual_seed(0))
    xs = torch.randn((4, 2, 128, tcfg.d_model), generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def layer_fn(lp, h):
        return block._layer(lp, h, positions(h.shape[0], h.shape[1], h.device), None)[0]

    def at(tree, i):
        return {k: at(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    def sequential():
        outs = []
        for h in xs:
            for i in range(tcfg.n_layers):
                h = layer_fn(at(stacked, i), h)
            outs.append(h)
        return torch.stack(outs)

    with torch.inference_mode():
        pipe = make_mesh((2,), ("pipe",), [dev] * 2)
        got, want = gpipe_forward(layer_fn, stacked, xs, mesh=pipe), sequential()
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        if not err <= LM_MESH_TOL:
            raise AssertionError(f"13c GPipe against the sequential run: {err:.3e}")
        t_pipe, t_seq = [], []
        for _ in range(3):
            for fn, acc in ((lambda: gpipe_forward(layer_fn, stacked, xs, mesh=pipe), t_pipe), (sequential, t_seq)):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                acc.append((time.perf_counter() - t0) * 1e3)
    log(f"lm mesh 13c (gpipe_forward, {tcfg.name}'s {tcfg.n_layers} decoder blocks, float32, 2 stages on {dev}, "
        f"4 microbatches of 2 x 128): against the sequential run {err:.1e} of the scale; ms pipeline "
        f"{[round(t, 2) for t in t_pipe]}, sequential {[round(t, 2) for t in t_seq]} [{smi}]")
    del stacked, xs, got, want, block

    # 13d: compressed_psum, card against CPU with the same noise
    wq = (tcfg.d_model, tcfg.n_heads, tcfg.resolved_head_dim)
    g = torch.Generator().manual_seed(2)
    cases = {"4 shards of wq": ([torch.randn(wq, generator=g) * s for s in (1.0, 0.5, 2.0, 0.01)],
                                [torch.rand(wq, generator=g) - 0.5 for _ in range(4)]),
             "scales differ": ([torch.tensor([1.0, 0.5]), torch.tensor([0.01, 0.01])], [torch.zeros(2)] * 2)}
    sums = {}
    for name, (shards, noise) in cases.items():
        sums[name] = compressed_psum(shards, noise)
        got = compressed_psum([s.to(dev) for s in shards], [n.to(dev) for n in noise])
        if not torch.equal(got.cpu(), sums[name]):
            raise AssertionError(f"13d compressed_psum {name}: card differs from CPU by "
                                 f"{float((got.cpu() - sums[name]).abs().max())}")
    skew = sums["scales differ"]
    if not torch.allclose(skew, torch.tensor([2.0, 1.504]), atol=5e-4):  # the true sum is [1.01, 0.51]
        raise AssertionError(f"13d: shards [1.0, 0.5] and [0.01, 0.01] give {skew.tolist()}, not [2.0, 1.504]")
    log(f"lm mesh 13d (compressed_psum, card against CPU, the same noise): {', '.join(cases)} equal bit for bit; "
        f"shards [1.0, 0.5] and [0.01, 0.01] give {[round(v, 4) for v in skew.tolist()]} (the reference's formula)")

    got = K.launches()
    if any(got.values()):
        raise AssertionError(f"phase 13 launched a kernel of this repo: {got}")
    took = time.perf_counter() - t_phase
    log(f"lm mesh: phase 13 took {took:.1f}s; kernel launches {json.dumps(got)} (the path has none)")
    if on_card and took > LM_MESH_BUDGET_S:
        raise AssertionError(f"phase 13 took {took:.1f}s, over its {LM_MESH_BUDGET_S:.0f}s budget")
    return nums


# ------------------------------------------------ phase 14: the dry-run tooling
DRYRUN_BUDGET_S = 150.0


@contextlib.contextmanager
def plain_kernels():
    """The miner's kernel ops replaced by their plain PyTorch versions, on
    whatever device the tensors lie (the reference run of phase 14a)."""
    import repro_torch.core.hprepost as hp
    from repro_torch.kernels.cooccur.ref import cooccur_ref
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.nlist_intersect.ref import nlist_wave_ref

    def ones(r):
        return torch.ones(r.shape[0], dtype=torch.int32, device=r.device)

    saved = hp.item_histogram, hp.cooccurrence_matrix, hp.nlist_wave
    hp.item_histogram = lambda r, n_bins, backend=None: histogram_ref(r, ones(r), n_bins=n_bins)
    hp.cooccurrence_matrix = lambda r, n_items, backend=None: cooccur_ref(r, ones(r), n_items=n_items)
    hp.nlist_wave = lambda planes, prev, idx, n_live, backend=None, la_block=512, early_stop=False, \
        min_count=0: nlist_wave_ref(planes, prev, idx, n_live, early_stop=early_stop,
                                    min_count=min_count, la_block=la_block)
    try:
        yield
    finally:
        hp.item_histogram, hp.cooccurrence_matrix, hp.nlist_wave = saved


def tensors_equal(name: str, got, want) -> None:
    """Exact equality of two nests of tensors (lists, tuples)."""
    if isinstance(got, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} parts against {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            tensors_equal(f"{name}[{i}]", g, w)
        return
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} against plain {want.shape}/{want.dtype}")
    if not torch.equal(got, want):
        bad = got != want
        rows = bad.reshape(bad.shape[0], -1).any(1).sum() if bad.dim() else bad
        raise AssertionError(f"{name}: {int(bad.sum())} entries in {int(rows)} rows differ from its plain "
                             f"run, max abs error {int((got.long() - want.long()).abs().max())}")


def h2d_phase(smi: str, rows: np.ndarray, n_items: int, min_count: int, reps: int = 9) -> dict:
    """Phase 15 (see the module docstring): ``rows`` (C-contiguous int32,
    pageable) to the card. Each timed copy follows an untimed one-shot mine
    of ``rows`` at ``min_count``, as a request of the one-shot cell finds the
    host's caches; host-clock medians over ``reps`` copies, each ending in a
    synchronise, after one warm-up. -> the measured rows."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import device as rd
    from repro_torch.core.hprepost import HPrepostMiner

    dev = torch.device("cuda")
    nbytes = rows.nbytes
    miner = HPrepostMiner(dev)

    def gbps(ms):
        return nbytes / ms / 1e6

    def median_ms(fn, n=reps):
        fn()
        ts = []
        for _ in range(n):
            miner.mine(rows, n_items, min_count)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    log(f"h2d: {rows.shape[0]:,} x {rows.shape[1]} int32 rows, {nbytes:,} bytes; "
        f"torch.get_num_threads() {torch.get_num_threads()}, CPUs usable "
        f"{len(os.sched_getaffinity(0))}, OMP_NUM_THREADS {os.environ.get('OMP_NUM_THREADS')}; {smi}")
    src = torch.from_numpy(rows)
    want = src.to(dev)
    block = torch.empty_like(want)
    out = {}

    def report(name, ms, **extra):
        out[name] = dict(ms=round(ms, 4), gb_s=round(gbps(ms), 2), **extra)
        log(f"  h2d {name}: {ms:.3f} ms, {gbps(ms):.2f} GB/s"
            + "".join(f", {k} {v}" for k, v in extra.items()))

    report("pageable_to", median_ms(lambda: src.to(dev)))
    ring = rd.StagingRing()
    report("ring", median_ms(lambda: ring.copy(rows, block)), slot_bytes=ring.slot_bytes,
           slots=ring.slots, fillers=ring.fillers)
    tensors_equal("h2d ring block", block, want)
    report("shard_rows", median_ms(lambda: miner._shard_rows(rows)))
    tensors_equal("h2d _shard_rows block", miner._shard_rows(rows)[0], want)

    # the ring's halves alone: its fillers' copies into pinned slots with no
    # DMA, and its chunks' DMAs from pinned slots with no fill
    S, n_slots = rd.SLOT_BYTES, rd.SLOTS
    slots = [torch.empty(S, dtype=torch.uint8, pin_memory=True) for _ in range(n_slots)]
    views = [t.numpy() for t in slots]
    src_b = rows.reshape(-1).view(np.uint8)
    pool = ThreadPoolExecutor(rd.FILLERS)

    def fills():
        futs = [pool.submit(np.copyto, views[i % n_slots][:min(S, nbytes - a)], src_b[a:a + S])
                for i, a in enumerate(range(0, nbytes, S))]
        for f in futs:
            f.result()

    report("fills_alone", median_ms(fills))
    pool.shutdown()
    pinned = src.pin_memory()
    report("pinned_dma_alone", median_ms(lambda: block.copy_(pinned, non_blocking=True)))
    block_b = block.view(-1).view(torch.uint8)

    def dmas():
        for i, a in enumerate(range(0, nbytes, S)):
            m = min(S, nbytes - a)
            block_b[a:a + m].copy_(slots[i % n_slots][:m], non_blocking=True)

    report("chunk_dmas_alone", median_ms(dmas))
    del slots, views, pinned

    # the sweep that fixed the ring's constants
    sweep = []
    for slot_mib in (4, 8, 16):
        for n in (4, 8):
            for fillers in (2, 3, 4, 6, 8):
                r = rd.StagingRing(slot_bytes=slot_mib << 20, slots=n, fillers=fillers)
                sweep.append((slot_mib, n, fillers, round(median_ms(lambda: r.copy(rows, block), n=5), 3)))
                r._pool.shutdown()
    tensors_equal("h2d sweep's last block", block, want)
    log("  h2d sweep (slot MiB, slots, fillers, median ms): " + json.dumps(sweep))
    best = min(sweep, key=lambda t: t[3])
    log(f"  h2d best of the sweep: slot {best[0]} MiB, {best[1]} slots, {best[2]} fillers, "
        f"{best[3]:.3f} ms ({gbps(best[3]):.2f} GB/s)")
    out["sweep"] = sweep
    del want, block, block_b
    torch.cuda.synchronize()
    return out


def dryrun_phase(smi: str, K, dev="cuda", scale: float = 1.0, sweep_mesh: str = "16x16",
                 jobs: int = 8) -> tuple[dict, dict]:
    """Phase 14 (see the module docstring). ``dev="cpu"`` with a small
    ``scale`` (and a small ``sweep_mesh``) rehearses it on the CPU. -> (this
    phase's launches, each kernel's entry at the production shapes)."""
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.kernels.cooccur import ref as cooc_ref
    from repro_torch.kernels.cooccur.ops import cooccur_cost
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.histogram.ops import histogram_cost
    from repro_torch.kernels.nlist_intersect import ref as nl_ref
    from repro_torch.kernels.nlist_intersect.ops import wave_cost
    from repro_torch.launch import dryrun, dryrun_fim
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.models.registry import SHAPES, applicable

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    R, C = int(1_048_576 * scale), int(8192 * scale) or 256

    # 14a: the FIM stages at production scale, each against its plain run
    K.reset_launches()
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for spec in ("1x1", "2x2"):
            n = math.prod(int(x) for x in spec.split("x"))
            outputs = {}
            t0 = time.perf_counter()
            recs = dryrun_fim.run(make_mesh_from_spec(spec, [dev] * n), spec, R=R, C=C, device=dev,
                                  out_dir=out_dir, reps=3, outputs=outputs)
            took = time.perf_counter() - t0
            runs[spec] = (recs, outputs)
            written = sorted(os.listdir(out_dir))
            if not all(f"fim_{st}__{spec}.json" in written for st in dryrun_fim.STAGES):
                raise AssertionError(f"dryrun_fim wrote {written}")
            for st, rec in recs.items():
                log(f"fim {st} x {spec}: {rec['ms']:.3f} ms (median of 3), bound {rec['bottleneck']} "
                    f"(t_compute {rec['t_compute'] * 1e3:.4f} t_memory {rec['t_memory'] * 1e3:.4f} "
                    f"t_collective {rec['t_collective'] * 1e3:.4f} ms), {rec['ratio']:.1f}x the bound, "
                    f"peak {rec['peak_device_bytes'] / MB:.1f} MiB, {rec['n_ops']} ops traced "
                    f"[R {rec['R']} x {rec['L']}, K {rec['K']}, W {rec['W']}, C {rec['C']}] [{smi}]")
            log(f"fim {spec}: run and costed in {took:.1f}s")
    got = K.launches()
    need = {"histogram", "cooccur", "nlist_intersect", "nlist_intersect_es"}
    if on_card and not all(got[k] > 0 for k in need):
        raise AssertionError(f"a kernel of the FIM stages was not launched in phase 14a: {got}")
    for spec, (recs, outputs) in runs.items():
        with plain_kernels():
            for st in dryrun_fim.STAGES:
                tensors_equal(f"fim {st} x {spec}", outputs[st], outputs["stages"][st]())
        log(f"  fim x {spec}: every stage equal to its run with the plain kernel versions on the card")
    if on_card:
        torch.cuda.synchronize()

    # the four kernels alone at the production shapes (the 1x1 stages' inputs)
    entries = {}
    inp = runs["1x1"][1]["inputs"]
    rows_d = torch.from_numpy(inp["rows"]).to(dev)
    w1 = torch.ones(rows_d.shape[0], dtype=torch.int32, device=dev)
    n_items = 41_270
    timing = time_ms if on_card else (lambda fn, **kw: float("nan"))
    b, by = bound_ms(*histogram_cost(rows_d, w1, n_bins=n_items))
    flat = rows_d.reshape(-1)
    valid = flat[flat >= 0].long()
    entries["histogram"] = dict(
        shape=f"Zipf rows {tuple(rows_d.shape)}, {n_items} bins", max_abs_err=assert_equal(
            "histogram fim", (K.histogram_cuda(rows_d, w1, n_bins=n_items),),
            (hist_ref.histogram_ref(rows_d, w1, n_bins=n_items),)),
        ms=timing(lambda: K.histogram_cuda(rows_d, w1, n_bins=n_items)),
        plain_ms=timing(lambda: hist_ref.histogram_ref(rows_d, w1, n_bins=n_items), reps=3),
        library_ms=timing(lambda: torch.bincount(valid, minlength=n_items)),
        library_call="torch.bincount over the valid ids (compacted outside the timing)",
        bound_ms=b, bound_by=by)
    ranked = runs["1x1"][1]["job2_tree"][0][0]
    k = inp["K"]
    nb, pairs = cooccur_cost(ranked, w1, n_items=k)
    b, by = bound_ms(nb, pairs)
    cooc = K.cooccur_cuda(ranked, w1, n_items=k)
    entries["cooccur"] = dict(
        shape=f"ranked rows {tuple(ranked.shape)}, K={k}, {pairs} pair updates",
        max_abs_err=assert_equal("cooccur fim", (cooc,), (cooc_ref.cooccur_ref(ranked, w1, n_items=k),)),
        ms=timing(lambda: K.cooccur_cuda(ranked, w1, n_items=k)),
        plain_ms=timing(lambda: cooc_ref.cooccur_ref(ranked, w1, n_items=k), reps=2),
        **cooccur_library(ranked, w1, k, cooc, timing, reps=3),
        bound_ms=b, bound_by=by)
    if on_card:
        extras = cooccur_extras(ranked, w1, k, timing)
        log_cooccur_extras(f"the production rows (K={k})", extras, smi)
        entries["cooccur"].update(measured_extras(extras))
    del cooc, valid, flat
    Cs, W = inp["C"] // inp["Mb"], inp["W"]
    planes = torch.from_numpy(inp["planes"][0]).to(dev)
    state = torch.from_numpy(inp["state"][0]).to(dev)
    idx = torch.from_numpy(np.ascontiguousarray(inp["idx_shuffle"])).to(dev)
    stop = inp["stop"]
    for kname, kw in (("nlist_intersect", {}),
                      ("nlist_intersect_es", dict(early_stop=True, min_count=stop, la_block=512))):
        nb, ops = wave_cost(planes, state, idx, Cs, **kw)
        b, by = bound_ms(nb, ops)
        entries[kname] = dict(
            shape=f"synthetic wave: C {Cs} x W {W}, planes (3, {k}, {W}), parents (C, W)"
                  + (f", min_count {stop}, la_block 512" if kw else ""),
            max_abs_err=assert_equal(f"{kname} fim", K.nlist_wave_cuda(planes, state, idx, Cs, **kw),
                                     nl_ref.nlist_wave_ref(planes, state, idx, Cs, **kw)),
            ms=timing(lambda: K.nlist_wave_cuda(planes, state, idx, Cs, **kw)),
            plain_ms=timing(lambda: nl_ref.nlist_wave_ref(planes, state, idx, Cs, **kw), reps=3),
            library_ms=None, bound_ms=b, bound_by=by)
    for kname, e in entries.items():
        tc = "".join(f", {key} {e[key]:.4f} ms" for key in ("bf16_ms", "int8_ms") if key in e)
        log(f"  {kname} at production shapes ({e['shape']}): {e['ms']:.4f} ms against plain "
            f"{e['plain_ms']:.3f} ms, library {e['library_ms']}{tc}, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) [{smi}]")
    del rows_d, w1, ranked, planes, state, idx, runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 14b: the LM dry-run over every cell on a 16x16 mesh of meta positions
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            dryrun.main(["--all", "--mesh", sweep_mesh, "--out", out_dir, "--jobs", str(jobs)])
        except SystemExit as e:
            raise AssertionError(f"the {sweep_mesh} dry-run sweep failed ({e.code})") from None
        recs = [json.load(open(os.path.join(out_dir, f))) for f in sorted(os.listdir(out_dir))]
    errors = [r for r in recs if "error" in r]
    done = [r for r in recs if "skipped" not in r and "error" not in r]
    skipped = [r for r in recs if "skipped" in r]
    want_done = sum(applicable(get_config(a), s)[0] for a in ARCH_IDS for s in SHAPES)
    if errors or len(done) != want_done or len(done) + len(skipped) != len(ARCH_IDS) * len(SHAPES):
        raise AssertionError(f"dry-run sweep: {len(done)} traced (want {want_done}), {len(skipped)} "
                             f"skipped, errors {errors[:3]}")
    for r in recs:
        if "skipped" in r:
            log(f"dryrun {r['arch']} x {r['shape']} x {r['mesh']}: skipped ({r['skipped']})")
        else:
            log(f"dryrun {r['arch']} x {r['shape']} x {r['mesh']}: trace {r['trace_s']}s, "
                f"flops/dev {r['flops_per_device']:.4g}, hbm {r['hbm_bytes_per_device']:.4g} B, "
                f"wire {r['collective_wire_bytes']:.4g} B -> {r['bottleneck']} (t_compute "
                f"{r['t_compute']:.4g} t_memory {r['t_memory']:.4g} t_collective "
                f"{r['t_collective']:.4g} s), useful {r['useful_flops_ratio']:.3f}, args/dev "
                f"{r['arg_bytes_per_device']} B, temp {r['mem_temp_size_in_bytes']} B")
    log(f"dryrun {sweep_mesh}: {len(done)} cells traced, {len(skipped)} skipped, none in error, in "
        f"{time.perf_counter() - t0:.1f}s ({jobs} processes)")
    took = time.perf_counter() - t_phase
    log(f"dry-run tooling: phase 14 took {took:.1f}s; kernel launches {json.dumps(got)}")
    if took > DRYRUN_BUDGET_S:
        raise AssertionError(f"phase 14 took {took:.1f}s, over its {DRYRUN_BUDGET_S:.0f}s budget")
    return got, entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # phase 12 trains under deterministic algorithms: cuBLAS reads its
    # workspace setting when the process first uses it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import repro_torch.kernels as K
    from repro_torch.core import encoding as enc
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
    from repro_torch.core.prepost import mine_prepost
    from repro_torch.data import synth
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.cooccur import ref as cooc_ref
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.cooccur.ops import cooccur_cost
    from repro_torch.kernels.histogram.ops import histogram_cost
    from repro_torch.kernels.nlist_intersect import ref as nl_ref
    from repro_torch.kernels.nlist_intersect.ops import wave_cost
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.mining import MineSpec, MiningEngine

    # ---------------------------------------------------------- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(smi)
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s for {len(_cuda.SOURCES)} sources "
        f"(parallel nvcc; per source {json.dumps({k: round(v, 1) for k, v in _cuda.build_seconds.items()})})")
    for name, text in _cuda.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- data (set-up)
    t0 = time.perf_counter()
    data = {name: synth.load(name, scale=1.0) for name in ("mushroom", "pumsb", "kosarak")}
    log(f"data: generated in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{k} {v[0].shape}" for k, v in data.items()))
    sups = {"mushroom": 0.15, "pumsb": 0.15, "kosarak": 0.01}
    counts = {k: max(1, math.ceil(sups[k] * len(data[k][0]) - 1e-9)) for k in data}

    # -------------------------------------------------------------- 3. kernels
    entries = {}
    miner = HPrepostMiner("cuda", HPrepostConfig())
    preps = {k: miner.prepare(data[k][0], data[k][1], counts[k]) for k in data}

    # B3 on each dataset's rows as Job 1 gives them (weights all ones), then
    # the cases the main path does not reach
    for name in ("kosarak", "pumsb", "mushroom"):
        rows_d = torch.from_numpy(data[name][0]).to(dev)
        n_bins = data[name][1]
        R, L = rows_d.shape
        w1 = torch.ones(R, dtype=torch.int32, device=dev)
        got = K.histogram_cuda(rows_d, w1, n_bins=n_bins)
        want = hist_ref.histogram_ref(rows_d, w1, n_bins=n_bins)
        err = assert_equal(f"histogram {name}", (got,), (want,))
        flat = rows_d.reshape(-1)
        valid = flat[(flat >= 0) & (flat < n_bins)].long()  # compacted outside the timing
        assert_equal(f"bincount {name}", (torch.bincount(valid, minlength=n_bins).to(torch.int32),), (want,))
        ids = torch.where(flat >= 0, flat.long(), n_bins)  # PAD -> one spare bin
        ones = torch.ones_like(ids, dtype=torch.int32)
        lib_out = torch.zeros(n_bins + 1, dtype=torch.int32, device=dev)
        b, by = bound_ms(*histogram_cost(rows_d, w1, n_bins=n_bins))
        e = dict(
            shape=f"{name} rows {R}x{L}, {n_bins} bins, {valid.numel()} valid slots", max_abs_err=err,
            ms=time_ms(lambda: K.histogram_cuda(rows_d, w1, n_bins=n_bins)),
            unqueued_ms=time_ms(lambda: K.histogram_cuda(rows_d, w1, n_bins=n_bins), queued=False),
            plain_ms=time_ms(lambda: hist_ref.histogram_ref(rows_d, w1, n_bins=n_bins)),
            library_ms=time_ms(lambda: torch.bincount(valid, minlength=n_bins)),
            library_call="torch.bincount over the valid ids (compacted outside the timing)",
            index_add_ms=time_ms(lambda: lib_out.zero_().index_add_(0, ids, ones)),
            index_add_call="index_add_ of ones over every slot, PAD mapped to one spare bin",
            bound_ms=b, bound_by=by,
        )
        if name == "kosarak":
            entries["histogram"] = dict(source="src/repro_torch/csrc/histogram.cu",
                                        replaces="src/repro/kernels/histogram/kernel.py:22", **e)
        else:
            entries["histogram"][f"at_{name}"] = e
        log(f"  B3 equal to its plain version on {name} ({R}x{L}, {n_bins} bins)")
        del rows_d, w1, flat, valid, ids, ones, lib_out
    for what, rows_d, wts, n_bins in hist_cases(dev):
        got = K.histogram_cuda(rows_d, wts, n_bins=n_bins)
        assert_equal(f"histogram, {what}", (got,), (hist_ref.histogram_ref(rows_d, wts, n_bins=n_bins),))
        log(f"  B3 equal to its plain version: {what}")
    del rows_d, wts

    # B4 on each dataset's ranked rows (pumsb K=292: 6 output tiles of 128
    # items; mushroom K=68: 1 of 128; kosarak K=57: 1 of 64), then a weighted, repeated-item
    # case at pumsb's shape, which sends rows through the exact scalar path
    for name in ("pumsb", "mushroom", "kosarak"):
        prep = preps[name]
        lut = torch.from_numpy(prep.fl.rank_lut()).to(dev)
        ranked = enc.rank_encode_torch(torch.from_numpy(data[name][0]).to(dev), lut, data[name][1])
        k = prep.fl.k
        wr = torch.ones(ranked.shape[0], dtype=torch.int32, device=dev)
        got = K.cooccur_cuda(ranked, wr, n_items=k)
        want = cooc_ref.cooccur_ref(ranked, wr, n_items=k)
        err = assert_equal(f"cooccur {name}", (got,), (want,))
        R, L = ranked.shape
        nb, pairs = cooccur_cost(ranked, wr, n_items=k)
        b, by = bound_ms(nb, pairs)
        e = dict(
            shape=f"{name} ranked rows {R}x{L}, K={k}, {pairs} pair updates", max_abs_err=err,
            ms=time_ms(lambda: K.cooccur_cuda(ranked, wr, n_items=k)),
            unqueued_ms=time_ms(lambda: K.cooccur_cuda(ranked, wr, n_items=k), queued=False),
            plain_ms=time_ms(lambda: cooc_ref.cooccur_ref(ranked, wr, n_items=k), reps=3),
            **cooccur_library(ranked, wr, k, got),
            bound_ms=b, bound_by=by,
        )
        extras = cooccur_extras(ranked, wr, k)
        log_cooccur_extras(f"{name} (K={k})", extras, smi)
        e.update(measured_extras(extras))
        if name == "pumsb":
            entries["cooccur"] = dict(source="src/repro_torch/csrc/cooccur.cu",
                                      replaces="src/repro/kernels/cooccur/kernel.py:23", **e)
            gen = torch.Generator(device=dev).manual_seed(12)
            heavy = ranked.clone()
            rep = torch.arange(0, R, 7, device=dev)
            heavy[rep, L - 1] = heavy[rep, 0]  # every 7th row repeats its first item
            ww = torch.where(torch.rand(R, generator=gen, device=dev) < 1 / 16,
                             torch.randint(0, (1 << 20) + 1, (R,), generator=gen, device=dev),
                             torch.ones(R, dtype=torch.int64, device=dev)).to(torch.int32)
            got = K.cooccur_cuda(heavy, ww, n_items=k)
            want = cooc_ref.cooccur_ref(heavy, ww, n_items=k)
            assert_equal("cooccur pumsb weighted, repeated items", (got,), (want,))
            entries["cooccur"]["weighted_repeated_ms"] = time_ms(lambda: K.cooccur_cuda(heavy, ww, n_items=k))
            log(f"  B4 equal to its plain version on pumsb's rows with every 7th row repeating "
                f"an item and 1/16 of the rows weighted up to 2^20")
            del heavy, ww, rep
        else:
            entries["cooccur"][f"at_{name}"] = e
        log(f"  B4 equal to its plain version on {name} (K={k})")
        del ranked, wr, lut

    # B1 and B2 at the level-2 waves of mushroom (W=2048), pumsb and kosarak
    # (both W=16384), through the wave entry the miner calls
    for name in ("mushroom", "pumsb", "kosarak"):
        planes, state, idx, n_live = level2_wave(miner, preps[name], counts[name])
        B, W = idx.shape[1], planes.shape[2]
        log(f"wave {name}: {n_live} candidates -> Cpad {B}, W {W}")
        got = K.nlist_wave_cuda(planes, state, idx, n_live)
        want = nl_ref.nlist_wave_ref(planes, state, idx, n_live)
        err1 = assert_equal(f"nlist_intersect {name}", got, want)
        exact = want[0][:n_live]
        mc = counts[name]
        labs = (512, 64, 8, 1)
        for stop in (0, mc // 2, mc, 2 * mc, 1 << 30):
            for lab in labs:
                kw = dict(early_stop=True, min_count=stop, la_block=lab)
                got = K.nlist_wave_cuda(planes, state, idx, n_live, **kw)
                want = nl_ref.nlist_wave_ref(planes, state, idx, n_live, **kw)
                assert_equal(f"nlist_intersect_es {name} min_count={stop} la_block={lab}", got, want)
        log(f"  B1 and B2 (wave entry) equal to their plain versions on {name} "
            f"(B2 at min_count 0, {mc // 2}, {mc}, {2 * mc}, 2^30 x la_block {', '.join(map(str, labs))})")
        # the bounds count what this wave's data needs, each input once (see
        # ops.wave_cost); B2's at min_count mc and la_block 512, the case
        # timed below
        live = idx[:, :n_live]
        dead_at = nl_ref.first_dead_slot(exact, planes[0][live[2]], planes[2][live[2]], mc, 512)
        by_1, ops1 = wave_cost(planes, state, idx, n_live)
        by_2, ops2 = wave_cost(planes, state, idx, n_live, early_stop=True, min_count=mc, la_block=512)
        shape = (f"{name} level-2 wave: {n_live} candidates, Cpad {B} x W {W}, "
                 f"{ops1 // (math.ceil(math.log2(W)) + 2)} nonzero Y codes, wave entry (no gathers)")
        b1, by1 = bound_ms(by_1, ops1)
        b2, by2 = bound_ms(by_2, ops2)
        na = (planes[0][live[2]] != torch.iinfo(torch.int32).max).sum(1)
        log(f"  bounds: B1 {by_1} bytes, B2 {by_2} bytes, each input read once "
            f"({int((dead_at < na).sum())} of {n_live} candidates die before their last valid slot)")
        e1 = dict(
            shape=shape, max_abs_err=err1,
            ms=time_ms(lambda: K.nlist_wave_cuda(planes, state, idx, n_live)),
            unqueued_ms=time_ms(lambda: K.nlist_wave_cuda(planes, state, idx, n_live), queued=False),
            plain_ms=time_ms(lambda: nl_ref.nlist_wave_ref(planes, state, idx, n_live), reps=3),
            library_ms=None, bound_ms=b1, bound_by=by1,
        )
        kw = dict(early_stop=True, min_count=mc, la_block=512)
        e2 = dict(
            shape=shape + f", min_count {mc}, la_block 512", max_abs_err=0,
            ms=time_ms(lambda: K.nlist_wave_cuda(planes, state, idx, n_live, **kw)),
            unqueued_ms=time_ms(lambda: K.nlist_wave_cuda(planes, state, idx, n_live, **kw), queued=False),
            plain_ms=time_ms(lambda: nl_ref.nlist_wave_ref(planes, state, idx, n_live, **kw), reps=3),
            library_ms=None, bound_ms=b2, bound_by=by2,
        )
        # one entry per kernel: the mushroom wave's numbers at top level, the
        # W=16384 waves' (pumsb, kosarak) beside them
        for kname, e, line in (("nlist_intersect", e1, 44), ("nlist_intersect_es", e2, 89)):
            if name == "mushroom":
                entries[kname] = dict(
                    source="src/repro_torch/csrc/nlist_intersect.cu",
                    replaces=f"src/repro/kernels/nlist_intersect/kernel.py:{line}", **e)
            else:
                entries[kname][f"at_{name}"] = e
        del planes, state, idx, live, exact, dead_at, na

    # the padding contract: B1 and B2 on soiled padding slots, at the mushroom
    # level-2 wave (W 2048) and at a 1,024-candidate wave on Job 2's real
    # N-lists at production scale (W 512)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    mc = counts["mushroom"]
    planes, state, idx, n_live = level2_wave(miner, preps["mushroom"], mc)
    n_pad = padding_contract(K, nl_ref, "mushroom level-2 wave", planes, state, idx, n_live,
                             (mc // 2, mc, 2 * mc), gen)
    planes, state, idx, n_live, stop = fim_wave(dev)
    n_pad += padding_contract(K, nl_ref, "production wave, W 512", planes, state, idx, n_live,
                              (stop // 2, stop, 2 * stop), gen)
    log(f"  B1 and B2 equal to their plain versions on soiled padding slots: {n_pad} comparisons "
        f"(states 0-4, count + 1, padding-only; A counts and posts on padding; B2 at 3 min_counts x "
        f"la_block 128/256/512; 256- and 1,024-thread blocks) in {time.perf_counter() - t0:.1f}s")
    del planes, state, idx, gen
    # phase 4 reports each mine's peak memory: nothing of phase 3 stays alive
    del preps, prep, got, want
    torch.cuda.synchronize()
    log("kernels: all four equal to their plain versions on the card")

    # ---------------------------------------------------------- 4. end to end
    # one-shot mines that pay for their own prep (no PreparedDB cache), so the
    # walls stay comparable with earlier slices' phase 4 and 5
    oneshot = MiningEngine(device="cuda", prep_cache_bytes=0)
    runs = [("mushroom", True), ("mushroom", False), ("pumsb", True), ("kosarak", True)]
    host = {}  # (dataset, min_count) -> the host PrePost miner's itemsets
    oneshot_itemsets = {}  # dataset -> this phase's 1x1 answer (phase 9 holds meshes to it)
    K.reset_launches()
    per_run = []
    for name, es in runs:
        rows, n_items = data[name]
        before = K.launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = oneshot.submit(rows, n_items, MineSpec(algorithm="hprepost", min_sup=sups[name],
                                                     early_stop=es))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        moved = {k: v - before[k] for k, v in K.launches().items()}
        t0 = time.perf_counter()
        ref = mine_prepost(rows, n_items, res.min_count)
        t_ref = time.perf_counter() - t0
        host[name, res.min_count] = ref.itemsets
        oneshot_itemsets[name] = res.itemsets
        if res.itemsets != ref.itemsets:
            raise AssertionError(f"{name} early_stop={es}: {len(res.itemsets)} itemsets vs "
                                 f"{len(ref.itemsets)} from the host PrePost miner")
        stages = {k: round(v, 4) for k, v in res.stage_times_s.items()}
        log(f"e2e {name}@{sups[name]} early_stop={es}: {len(rows)} rows, min_count {res.min_count}, "
            f"{len(res.itemsets)} itemsets == host mine_prepost ({t_ref:.1f}s); wall {wall:.3f}s, "
            f"peak device memory {peak / MB:.1f} MiB, launches {json.dumps(moved)}, stages {json.dumps(stages)}")
        per_run.append((name, es, moved))
    total = K.launches()  # phase 4's launches; phase 6 adds its own below
    es_on = [m for n, e, m in per_run if e]
    es_off = [m for n, e, m in per_run if not e]
    if not all(m["nlist_intersect_es"] > 0 for m in es_on):
        raise AssertionError(f"the early-stop wave kernel did not run on every early-stop mine: {per_run}")
    if not all(m["nlist_intersect"] > 0 for m in es_off):
        raise AssertionError(f"the exact wave kernel did not run on the no-early-stop mine: {per_run}")
    if not all(m["histogram"] > 0 and m["cooccur"] > 0 for _, _, m in per_run):
        raise AssertionError(f"a prep kernel did not run on every mine: {per_run}")

    # ------------------------------------------------- 5. where the time goes
    # each mine once more, warm, under the profiler: device busy time (the
    # union of the device-side kernel and copy intervals) over the host wall
    # time, and the device ops that take most of it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, es in runs:
        rows, n_items = data[name]
        spec = MineSpec(algorithm="hprepost", min_sup=sups[name], early_stop=es)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = oneshot.submit(rows, n_items, spec)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans, by_name = [], {}
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA or ev.name.startswith("Activity Buffer"):
                continue
            spans.append((ev.time_range.start, ev.time_range.end))
            tot, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + (ev.time_range.end - ev.time_range.start) / 1e3, n + 1)
        busy, last = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > last:
                busy += (b - max(a, last)) / 1e3
                last = b
        stages = {k: round(v, 4) for k, v in res.stage_times_s.items() if not k.startswith(("planned", "host_"))}
        head = f"profile {name}@{sups[name]} early_stop={es} (warm): wall {wall_ms:.1f}ms"
        if busy > 0:
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            top = "; ".join(f"{k[:70]} x{n} {ms:.3f}ms" for k, (ms, n) in top)
            gathers = [(n, ms) for k, (ms, n) in by_name.items() if "index_elementwise" in k]
            gathers = f"x{sum(n for n, _ in gathers)} {sum(ms for _, ms in gathers):.3f}ms"
            log(f"{head}, device busy {busy:.1f}ms, idle share {1 - busy / wall_ms:.3f}; "
                f"stages {json.dumps(stages)}; index_elementwise_kernel (gathers) {gathers}; "
                f"top device ops: {top}")
        else:
            log(f"{head}, device time not measured (the profiler recorded none)")

    # ---------------------------------------------------- 6. the resident engine
    engine_launches = engine_phase(K, data, host)
    log(f"engine: launches {json.dumps(engine_launches)}")

    # ---------------------------------------------------- 7. the resident service
    service_launches = service_phase(K, data, host)
    log(f"service: launches {json.dumps(service_launches)}")

    # ------------------------------------- 8. streaming and continuous mining
    stream_launches, stream_entries, stream4 = stream_phase(K, data, host, smi)
    log(f"stream: launches {json.dumps(stream_launches)}")
    for kname, e in stream_entries.items():
        entries[kname]["at_stream_pumsb_segment"] = e

    # ------------------------------------------------- 9. HPrepost on a mesh
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(K, data, host, smi, oneshot_itemsets)
    log(f"mesh: launches {json.dumps(mesh_launches)}; phase 9 took {time.perf_counter() - t0:.1f}s")

    # ------------------------- 10. JobTracker and TaskTrackers as processes
    t0 = time.perf_counter()
    dist_launches = distributed_phase(K, data, host, smi, stream4, oneshot_itemsets)
    log(f"distributed: workers' launches {json.dumps(dist_launches)}; phase 10 took "
        f"{time.perf_counter() - t0:.1f}s")

    # ------------------------------------------ 11. the LM scaffold's serving
    lm_phase(smi)

    # ------------------------------------------ 12. the LM scaffold's training
    lm_train_phase(smi, K)

    # ------------------------------- 13. the LM scaffold's training over a mesh
    lm_mesh_phase(smi, K)

    # --------------------------------------------------- 14. the dry-run tooling
    dry_launches, dry_entries = dryrun_phase(smi, K)
    for kname, e in dry_entries.items():
        entries[kname]["at_fim_production"] = e

    # ------------------------------------------------------- 15. the rows' copy
    h2d_phase(smi, np.require(data["kosarak"][0], np.int32, ["C"]), data["kosarak"][1], counts["kosarak"])

    kernels = []
    for kname, e in entries.items():
        n = (total[kname] + engine_launches[kname] + service_launches[kname]
             + stream_launches[kname] + mesh_launches[kname] + dist_launches[kname]
             + dry_launches[kname])
        kernels.append(dict(name=kname, route="cuda", launches=n, kernel_ms=e["ms"], **e))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
