"""Mining launcher for the port (the paper's pipeline as a CLI):

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom --scale 1.0 --min-sup 0.15
    PYTHONPATH=src python -m repro_torch.launch.mine --algo fpgrowth --dataset chess --min-sup 0.8
    PYTHONPATH=src python -m repro_torch.launch.mine --corpus --vocab 1024 --min-sup 0.02
    PYTHONPATH=src python -m repro_torch.launch.mine --dataset chess --scale 0.1 --device cpu

``hprepost`` runs on the CUDA device unless ``--device cpu`` is given,
which runs every kernel's plain PyTorch version on the CPU.

``--mesh DxM`` (or ``PxDxM``) runs it on a mesh: D data shards, each with
its own PPC-tree and N-lists, by M candidate groups. The mesh takes the
first D·M CUDA devices and raises when there are fewer; with ``--device``
every position goes on that one device (``--device cpu --mesh 4x2`` puts
eight positions on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom --scale 0.05 \\
        --min-sup 0.3 --device cpu --mesh 4x2

``--sweep`` runs the paper's x-axis (several thresholds over one database)
through the engine's planned path — prep stages run once at the loosest
threshold, every threshold is served from the shared PreparedDB:

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom --sweep 0.4,0.3,0.2

``--snapshot-dir`` binds the persistent PreparedDB store: prep built in
one process is spilled to disk, and a later process on the same database
warm-starts with zero prep stages. ``--tune`` resolves the early-stop
kernel's ``la_block`` through the autotuner, whose plans persist as
``kernel_plans.json`` in the snapshot dir; ``--expect-plans cold|warm``
fails the run unless it searched (cold) or made zero trials (warm):

    PYTHONPATH=src python -m repro_torch.launch.mine --tune --snapshot-dir /tmp/snaps \\
        --dataset mushroom --expect-plans cold

``--serve`` routes the request load through the resident ``MiningService``
(concurrent submits, batching window, cross-group overlap with each prepare
on its own CUDA stream) instead of blocking per call; with
``--expect-warm`` the run fails unless it was served entirely from
snapshots. ``--stats`` dumps the service's operator snapshot,
``--stats-interval S`` runs a background stats emitter (``--stats-out``),
``--trace FILE`` saves the request span trees as Chrome trace events, and
``--expect-obs`` fails the run unless all three delivered:

    PYTHONPATH=src python -m repro_torch.launch.mine --serve --snapshot-dir /tmp/snaps \\
        --dataset mushroom --sweep 0.4,0.3,0.2 --device cpu

``--append N`` is the streaming path: the dataset is split into N batches
and ingested one by one (each batch is prepared alone, as a segment of a
live segmented database) and the sweep is served from the stream. With
``--window W`` only the last W batches are retained (older segments
expire at append time) and the windowed answer is checked against a
one-shot mine over exactly the window's rows; ``--watch`` registers a
standing query first, prints the ``MineDiff`` each append delivers and
checks that the diffs replay to the final answer. With ``--snapshot-dir``
a second run with ``--expect-warm`` fails unless every segment was restored
from its snapshot:

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom --scale 0.05 \\
        --append 4 --window 2 --watch --min-sup 0.3 --device cpu

``--workers W`` with ``--append`` is the distributed path: W spawned worker
processes (each bound to a device of its own: ``cuda:{wid % cards}``, or
``--device``) behind a coordinator that places each batch on one worker and
broadcasts every planned wave. ``--kill-worker`` hard-kills the lowest live
worker after the sweep and fails unless the re-mined sweep is bit-identical
(and, with ``--snapshot-dir``, recovered without rebuilding a segment);
``--respawn N`` budgets N worker restarts; ``--stats`` dumps the
coordinator's counters and the latency histograms:

    PYTHONPATH=src python -m repro_torch.launch.mine --append 4 --workers 2 --kill-worker \\
        --respawn 1 --snapshot-dir /tmp/snaps --dataset mushroom --sweep 0.3,0.2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch.data import corpus, synth
from repro_torch.mining import MineSpec, MiningEngine, list_miners
from repro_torch.mining.tune import registered_backends


def _placement(args) -> dict:
    """The engine's device or mesh from ``--device`` / ``--mesh``."""
    if args.mesh is None:
        return {"device": args.device}
    from repro_torch.launch.mesh import make_mesh_from_spec

    devices = None
    if args.device is not None:
        devices = [args.device] * math.prod(int(x) for x in args.mesh.split("x"))
    return {"mesh": make_mesh_from_spec(args.mesh, devices)}


def _report_plans(engine, expect: str | None) -> None:
    """Print the engine tuner's counters; with ``--expect-plans`` enforce
    the cold (searched this process) / warm (served entirely from
    kernel_plans.json, zero trials) contract."""
    st = engine.tuner.stats
    print(
        f"tuner: trials={st['trials']} tuned={st['tuned']} "
        f"plan_hits={st['plan_hits']} loaded_plans={st['loaded_plans']}"
    )
    if expect == "cold" and (st["trials"] == 0 or st["tuned"] == 0):
        raise SystemExit(f"expected a cold tune (timed trials > 0) but tuner stats = {st}")
    if expect == "warm" and (
        st["trials"] != 0 or st["loaded_plans"] == 0 or st["plan_hits"] == 0
    ):
        raise SystemExit(
            f"expected warm plans (zero trials, served from kernel_plans.json) "
            f"but tuner stats = {st}"
        )


def _verify_obs(args, snap, emitter, rec) -> None:
    """``--expect-obs``: fail unless the run emitted live periodic stats
    snapshots (not just the final one), wrote a loadable Chrome trace-event
    file, and populated the queue-wait / prep / mine latency histograms in
    the service stats snapshot."""
    if emitter is None or emitter.stats["periodic"] < 2:
        periodic = emitter.stats["periodic"] if emitter is not None else 0
        raise SystemExit(
            f"expected >=2 periodic stats snapshots during the run but the "
            f"emitter delivered {periodic} (interval={args.stats_interval}s); "
            f"emitter stats = {emitter.stats if emitter else None}"
        )
    with open(args.trace) as f:
        events = json.load(f)
    bad = [e for e in events if not ("name" in e and "ph" in e and "ts" in e)]
    if not events or bad:
        raise SystemExit(
            f"{args.trace} is not a valid Chrome trace-event list: "
            f"{len(events)} events, {len(bad)} malformed"
        )
    if rec is not None and len(rec) != len(events):
        raise SystemExit(
            f"trace file lost spans: recorder holds {len(rec)}, "
            f"file holds {len(events)}"
        )
    hists = (snap or {}).get("histograms", {})
    for key in ("admission.queue_wait_s", "engine.prep_s", "engine.mine_s",
                "service.request_s"):
        h = hists.get(key)
        if not h or h.get("count", 0) < 1 or "p95_s" not in h:
            raise SystemExit(
                f"expected a populated latency histogram {key!r} in "
                f"stats()['histograms'] but found {h!r} "
                f"(present: {sorted(hists)})"
            )
    print(
        f"observability verified: {emitter.stats['periodic']} periodic "
        f"snapshot(s), {len(events)} trace event(s), "
        f"{len(hists)} live histogram(s)"
    )


def _serve(args, rows, n_items: int, name: str, spec: MineSpec):
    """Serve the request load through a resident MiningService: the sweep
    (or the single threshold) submitted concurrently, plus one
    host-algorithm request riding the same batch on a worker thread.
    ``--stats-interval`` rides a background ``StatsEmitter`` over
    ``svc.stats`` for the whole serve; ``--trace`` attaches a
    ``TraceRecorder`` and saves the request span trees as Chrome trace
    events after the drain."""
    import contextlib

    from repro_torch.mining.service import MiningService
    from repro_torch.mining.telemetry import StatsEmitter, TraceRecorder, trace

    fracs = [float(s) for s in args.sweep.split(",")] if args.sweep else [args.min_sup]
    rec = TraceRecorder() if args.trace else None
    emitter = None
    snap = None
    with contextlib.ExitStack() as stack:
        svc = stack.enter_context(MiningService(
            **_placement(args), snapshot_dir=args.snapshot_dir, batch_window_s=0.05
        ))
        if args.stats_interval:
            emitter = stack.enter_context(StatsEmitter(
                svc.stats, args.stats_out, interval_s=args.stats_interval
            ))
        if rec is not None:
            stack.enter_context(trace.attached(rec))
        futures = svc.sweep(rows, n_items, spec, fracs)
        labels = [f"min_sup={f:g}" for f in fracs]
        if spec.algorithm != "apriori":
            futures.append(svc.submit(
                rows, n_items, spec.with_(algorithm="apriori", min_sup=min(fracs))
            ))
            labels.append("apriori (host pool)")
        svc.drain()
        results = [f.result() for f in futures]
        engine = svc.engine
        print(
            f"{name}: {len(rows)} tx served as {svc.stats['batches']} batch(es), "
            f"{svc.stats['requests']} concurrent requests"
        )
        for label, res in zip(labels, results):
            s = res.service_stats
            extras = [f"queue {s.get('queue_time_s', 0) * 1e3:.1f}ms"]
            if "prep_source" in s:
                extras.append(f"prep={s['prep_source']}")
            if s.get("prep_overlapped"):
                extras.append("overlapped")
            print(f"  {label} -> {res.summary()} [{', '.join(extras)}]")
        info = engine.cache_info()
        print(
            f"engine: prepares={engine.stats['prepares']} "
            f"snapshot_hits={info['snapshot_hits']} "
            f"scheduler={svc.scheduler.stats}"
        )
        if args.expect_warm:
            # per-request attribution, not just aggregate counters:
            # stats["prepares"] counts group builds only, so a degraded
            # per-request rebuild would slip past it — any hprepost result
            # whose prep was "built" means the warm start did not hold
            built = [
                label for label, res in zip(labels, results)
                if res.algorithm == "hprepost"
                and res.service_stats.get("prep_source") not in ("snapshot", "cache")
            ]
            if (engine.stats["prepares"] != 0 or info["snapshot_hits"] < 1
                    or info["snapshot_misses"] != 0 or built):
                raise SystemExit(
                    f"expected a snapshot warm start but prepares="
                    f"{engine.stats['prepares']}, snapshot_hits={info['snapshot_hits']}, "
                    f"snapshot_misses={info['snapshot_misses']}, "
                    f"non-snapshot requests={built} "
                    f"(snapshot store: {info.get('snapshot_store')})"
                )
            print("warm start verified: zero prep stages, served from snapshots")
        if args.tune or args.expect_plans:
            _report_plans(engine, args.expect_plans)
        if args.stats or args.expect_obs:
            snap = svc.stats()
        if args.stats:
            print(json.dumps(snap, indent=2, sort_keys=True, default=str))
    if rec is not None:
        n_ev = rec.save_chrome(args.trace)
        print(f"trace: {n_ev} span event(s) -> {args.trace}")
    if emitter is not None:
        print(
            f"stats emitter: {emitter.stats['periodic']} periodic + 1 final "
            f"snapshot(s) -> {args.stats_out}, dropped={emitter.stats['dropped']}"
        )
    if args.expect_obs:
        _verify_obs(args, snap, emitter, rec)
    return results


def _append_distributed(args, rows, n_items: int, name: str, spec: MineSpec):
    """Distributed path: spawn ``--workers`` worker processes behind the
    coordinator, stream the dataset in as ``--append`` batches (each
    placed on one worker), serve the sweep with waves broadcast over RPC.
    With ``--kill-worker`` the lowest live worker is hard-killed after the
    first sweep; the re-mined sweep must answer bit-identically, and with
    a snapshot dir the re-assigned segments must restore without any
    rebuild."""
    import numpy as np

    engine = MiningEngine(**_placement(args), snapshot_dir=args.snapshot_dir)
    dm = engine.distribute(
        n_items=n_items, workers=args.workers, spec=spec,
        restart_budget=args.respawn,
    )
    try:
        print("  workers: " + ", ".join(
            f"{w.wid} on {w.device} (pid {w.pid}, hello after {w.hello_s:.2f}s)"
            for w in dm._live()))
        batches = np.array_split(rows, args.append)
        for i, batch in enumerate(batches):
            st = dm.append(batch)
            print(
                f"  append[{i}]: +{st['rows']} rows -> worker {st['worker']}, "
                f"{st['segments']} segment(s), prep={st['prep_source']}, "
                f"{st['append_s'] * 1e3:.1f}ms"
            )
        fracs = [float(s) for s in args.sweep.split(",")] if args.sweep else [args.min_sup]
        results = []
        for frac in fracs:
            res = engine.submit_stream(spec.with_(min_sup=frac))
            results.append(res)
            print(f"  min_sup={frac:g} -> {res.summary()} "
                  f"[{res.service_stats['stream_segments']} segments, "
                  f"{res.service_stats['workers']} workers]")
        print(
            f"{name}: {len(rows)} tx streamed as {args.append} batches "
            f"over {args.workers} workers"
        )
        if args.kill_worker:
            victim = min(w.wid for w in dm._live())
            print(f"  killing worker {victim} (hard, mid-topology) ...")
            dm.kill_worker(victim)
            for frac, before in zip(fracs, results):
                after = dm.mine(spec.with_(min_sup=frac))
                if after.itemsets != before.itemsets:
                    raise SystemExit(
                        f"post-kill sweep diverged at min_sup={frac:g}: "
                        f"{len(after.itemsets)} vs {len(before.itemsets)} itemsets"
                    )
            st = dm.stats
            print(
                f"  recovered: failovers={st['failovers']} "
                f"reassigned={st['reassigned_segments']} "
                f"snapshot_restores={st['reassign_snapshot_restores']} "
                f"rebuilds={st['reassign_rebuilds']} "
                f"respawns={st['respawns']} live={len(dm._live())}"
            )
            if args.respawn and st["respawns"] == 0:
                raise SystemExit(
                    f"--respawn {args.respawn} given but no worker was respawned"
                )
            if args.snapshot_dir and st["reassign_rebuilds"] != 0:
                raise SystemExit(
                    f"expected snapshot-only recovery but "
                    f"{st['reassign_rebuilds']} segment(s) were rebuilt"
                )
            print(
                "recovery verified: bit-identical sweep after worker death"
                + (", segments restored from snapshots only" if args.snapshot_dir else "")
            )
        if args.tune or args.expect_plans:
            _report_plans(engine, args.expect_plans)
        if args.stats:
            # the coordinator's counters plus the engine registry's
            # distribution view (per-worker wave RPC latencies included)
            tel = engine.telemetry.snapshot()
            snap = dict(dm.stats)
            snap["histograms"] = tel["histograms"]
            snap["telemetry"] = {
                "schema": tel["schema"], "counters": tel["counters"],
                "gauges": tel["gauges"],
            }
            print(json.dumps(snap, indent=2, sort_keys=True, default=str))
        return results
    finally:
        dm.close()


def _append(args, rows, n_items: int, name: str, spec: MineSpec):
    """Streaming path: split the dataset into ``--append`` batches, ingest
    them through the engine's stream, serve the sweep from the live
    SegmentedDB, and (with ``--expect-warm``) verify a replayed process
    restored every segment from the snapshot store with zero prep.

    ``--window W`` turns the stream into a sliding window over the last W
    batches (older segments expire at append time) and verifies the
    windowed answer bit-identical to a one-shot mine over exactly the
    window's rows. ``--watch`` registers a standing query up front and
    prints the ``MineDiff`` each append delivers; at the end the diff
    stream replayed from empty must equal the final answer."""
    import numpy as np

    engine = MiningEngine(**_placement(args), snapshot_dir=args.snapshot_dir)
    sspec = None
    if args.window:
        from repro_torch.mining.stream import StreamSpec

        sspec = StreamSpec(window_batches=args.window)
    watch = None
    if args.watch:
        engine.stream(n_items=n_items, spec=spec, stream_spec=sspec)
        watch = engine.register_standing(spec)
        print(f"  watch: standing query registered "
              f"({watch.diffs[-1].total} itemsets at register)")
    batches = np.array_split(rows, args.append)
    for i, batch in enumerate(batches):
        st = engine.append(batch, n_items, spec=spec, stream_spec=sspec)
        line = (
            f"  append[{i}]: +{st['rows']} rows -> {st['segments']} segment(s), "
            f"{st['new_items']} new item(s), prep={st['prep_source']}, "
            f"{st['append_s'] * 1e3:.1f}ms"
        )
        if args.window:
            line += f", expired={st['expired']} (-{st['expired_rows']} rows)"
        print(line)
        if watch is not None and watch.diffs[-1].cause != "register":
            d = watch.diffs[-1]
            print(f"    diff[{d.seq}] {d.cause}: +{len(d.entered)} "
                  f"-{len(d.left)} ~{len(d.changed)} -> {d.total} itemsets "
                  f"over {d.n_rows} rows ({d.latency_s * 1e3:.1f}ms)")
    fracs = [float(s) for s in args.sweep.split(",")] if args.sweep else [args.min_sup]
    results = []
    for frac in fracs:
        res = engine.submit_stream(spec.with_(min_sup=frac))
        results.append(res)
        print(f"  min_sup={frac:g} -> {res.summary()} "
              f"[{res.service_stats['stream_segments']} segments]")
    stream = engine.stream()
    s = stream.stats
    line = (
        f"{name}: {len(rows)} tx streamed as {args.append} batches; "
        f"seg_prepares={s['seg_prepares']} snapshot_hits={s['seg_snapshot_hits']} "
        f"compactions={s['compactions']}"
    )
    if args.window:
        line += f" expires={s['expires']} expired_rows={s['expired_rows']}"
    print(line)
    if args.window:
        # the windowed answer must be bit-identical to a one-shot mine over
        # exactly the window's rows (the continuous-mining anchor)
        wrows = np.concatenate(batches[-args.window:])
        ref = engine.submit(wrows, n_items, spec)
        live = engine.submit_stream(spec)
        if live.n_rows != len(wrows) or live.itemsets != ref.itemsets:
            raise SystemExit(
                f"windowed mine diverged from the one-shot over the window: "
                f"{len(live.itemsets)} itemsets over {live.n_rows} rows vs "
                f"{len(ref.itemsets)} over {len(wrows)}"
            )
        print(f"window parity verified: last {args.window} batches "
              f"({len(wrows)} rows), {len(live.itemsets)} itemsets bit-identical")
    if watch is not None:
        from repro_torch.mining.continuous import replay_diffs

        final = engine.submit_stream(spec)
        replayed = replay_diffs(watch.diffs)
        if replayed != watch.latest or replayed != final.itemsets:
            raise SystemExit(
                f"standing diff stream does not replay to the live answer: "
                f"{len(replayed)} vs {len(final.itemsets)} itemsets"
            )
        print(f"watch verified: {len(watch.diffs)} diffs replay from empty "
              f"to the live answer ({len(replayed)} itemsets); "
              f"seed-pruned {s['seed_pruned_candidates']} candidate(s)")
    if args.expect_warm:
        # every already-seen segment must restore from its snapshot — a
        # single rebuilt segment means the warm start did not hold
        if s["seg_prepares"] != 0 or s["seg_snapshot_hits"] < args.append:
            raise SystemExit(
                f"expected a segment warm start but seg_prepares="
                f"{s['seg_prepares']}, seg_snapshot_hits={s['seg_snapshot_hits']} "
                f"(appends={args.append}, snapshot_misses={s['seg_snapshot_misses']})"
            )
        print("warm start verified: all segments restored from snapshots")
    if args.tune or args.expect_plans:
        _report_plans(engine, args.expect_plans)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="hprepost", choices=list_miners())
    ap.add_argument("--dataset", default=None, choices=[None, *synth.FIMI_SURROGATES])
    ap.add_argument("--corpus", action="store_true", help="mine token n-grams from the LM corpus")
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--min-sup", type=float, default=0.01)
    ap.add_argument(
        "--sweep", default=None, metavar="S1,S2,...",
        help="comma-separated min-sup thresholds mined as one planned sweep "
             "(shared prep at the loosest threshold); overrides --min-sup",
    )
    ap.add_argument("--max-k", type=int, default=5)
    ap.add_argument("--patterns", default="all", choices=["all", "closed", "maximal", "top_rank_k"])
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument(
        "--snapshot-dir", default=None, metavar="DIR",
        help="persistent PreparedDB store: spill prep here and warm-start from it",
    )
    ap.add_argument(
        "--serve", action="store_true",
        help="route requests through the resident MiningService "
             "(concurrent submits, batching window, cross-group overlap)",
    )
    ap.add_argument(
        "--expect-warm", action="store_true",
        help="with --serve / --append: fail unless the whole load was served "
             "from snapshots with zero prep stages",
    )
    ap.add_argument(
        "--append", type=int, default=0, metavar="N",
        help="streaming path: split the dataset into N batches, ingest them "
             "one by one (each preps only its own segment), and serve "
             "--sweep/--min-sup from the live segmented database",
    )
    ap.add_argument(
        "--window", type=int, default=0, metavar="W",
        help="with --append: sliding window — retain only the last W "
             "batches (older segments expire exactly at append time) and "
             "verify the windowed answer bit-identical to a one-shot mine "
             "over the window's rows",
    )
    ap.add_argument(
        "--watch", action="store_true",
        help="with --append: register a standing query before ingest, print "
             "the MineDiff each append delivers, and verify the diff stream "
             "replays from empty to the final live answer",
    )
    ap.add_argument(
        "--workers", type=int, default=0, metavar="W",
        help="with --append: distributed path — spawn W worker processes "
             "(coordinator/worker over RPC, each on a device of its own) and "
             "place segments on them",
    )
    ap.add_argument(
        "--respawn", type=int, default=0, metavar="N",
        help="with --workers: restart budget — dead workers are replaced by "
             "freshly spawned ones (segments migrate back snapshot-first) up "
             "to N times before the pool is allowed to shrink",
    )
    ap.add_argument(
        "--kill-worker", action="store_true",
        help="with --workers: after the first sweep, hard-kill one worker, "
             "re-mine, and fail unless the answers are bit-identical (and, "
             "with --snapshot-dir, recovered without rebuilding a segment)",
    )
    ap.add_argument(
        "--stats", action="store_true",
        help="after serving, dump the full operator stats snapshot as JSON "
             "(admission/shed/deadline/retry/respawn counters and per-layer "
             "drill-down; with --workers, the coordinator's stats dict)",
    )
    ap.add_argument(
        "--stats-interval", type=float, default=0.0, metavar="S",
        help="with --serve: run a background stats emitter for the whole "
             "serve, writing one JSON-lines snapshot of the full operator "
             "stats (latency histograms included) every S seconds",
    )
    ap.add_argument(
        "--stats-out", default="-", metavar="FILE",
        help="sink for --stats-interval snapshots: a file path (appended, "
             "parent dirs created) or '-' for stderr (the default)",
    )
    ap.add_argument(
        "--trace", default=None, metavar="FILE",
        help="with --serve: record per-request span trees (submit -> "
             "admission wait -> classify -> prep -> waves -> reduce -> "
             "resolve) and save them as Chrome trace events",
    )
    ap.add_argument(
        "--expect-obs", action="store_true",
        help="with --serve --stats-interval --trace: fail unless >=2 "
             "periodic snapshots were emitted while serving, the trace "
             "file is a valid Chrome trace-event list, and the queue-wait "
             "/ prep / mine histograms are populated",
    )
    ap.add_argument(
        "--backend", default="auto", choices=registered_backends(),
        help="kernel backend for hprepost (auto resolves to the CUDA kernels "
             "on a CUDA device, the plain torch versions on the CPU)",
    )
    ap.add_argument(
        "--no-early-stop", action="store_true",
        help="disable early-stopping intersections (host Apriori-closure "
             "pruning + the masked wave kernel) and run the exact path",
    )
    ap.add_argument(
        "--tune", action="store_true",
        help="resolve the early-stop kernel's la_block through the persisted "
             "autotuner (kernel_plans.json next to --snapshot-dir) instead of "
             "the static default",
    )
    ap.add_argument(
        "--expect-plans", default=None, choices=["cold", "warm"],
        help="with --tune: fail unless the tuner ran a timed search this "
             "process (cold) or served every plan from kernel_plans.json "
             "with zero trials (warm)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument(
        "--mesh", default=None, metavar="DxM|PxDxM",
        help="hprepost on a mesh of D data shards by M candidate groups "
             "(default 1x1: one device); the first D*M CUDA devices, or every "
             "position on --device when it is given",
    )
    args = ap.parse_args(argv)
    if args.expect_plans and not args.tune:
        ap.error("--expect-plans needs --tune")
    if args.append and args.serve:
        ap.error("--append and --serve are separate paths; pick one")
    if args.workers and not args.append:
        ap.error("--workers needs --append N (the distributed ingest path)")
    if (args.window or args.watch) and not args.append:
        ap.error("--window/--watch need --append N (the streaming path)")
    if (args.window or args.watch) and args.workers:
        ap.error("--window/--watch drive the single-process stream; the "
                 "distributed window rides the coordinator's stream_spec")
    if args.kill_worker and args.workers < 2:
        ap.error("--kill-worker needs --workers >= 2 (someone must survive)")
    if args.respawn and not args.workers:
        ap.error("--respawn needs --workers (it budgets worker restarts)")
    if args.expect_warm and not (args.serve or args.append):
        ap.error("--expect-warm checks a warm start; use it with --serve or --append")
    if args.expect_warm and args.workers:
        ap.error("--expect-warm checks the single-process stream; with --workers, "
                 "--kill-worker checks the snapshot-only recovery")
    if args.stats and not (args.serve or args.workers):
        ap.error("--stats dumps the service/coordinator snapshot; "
                 "use it with --serve or --workers")
    if (args.stats_interval or args.trace) and not args.serve:
        ap.error("--stats-interval/--trace ride the resident service; "
                 "use them with --serve")
    if args.expect_obs and not (args.serve and args.stats_interval and args.trace):
        ap.error("--expect-obs needs --serve --stats-interval S --trace FILE")

    if args.corpus:
        toks = corpus.token_stream(200_000, args.vocab, seed=0)
        rows = corpus.ngram_transactions(toks, window=8, stride=4)
        n_items = args.vocab
        name = "corpus-ngrams"
    else:
        rows, n_items = synth.load(args.dataset or "mushroom", scale=args.scale)
        name = args.dataset or "mushroom"

    spec = MineSpec(
        algorithm=args.algo, min_sup=args.min_sup, max_k=args.max_k,
        patterns=args.patterns, backend=args.backend,
        early_stop=not args.no_early_stop, tune=args.tune,
    )
    if args.serve:
        return _serve(args, rows, n_items, name, spec)
    if args.append:
        if args.workers:
            return _append_distributed(args, rows, n_items, name, spec)
        return _append(args, rows, n_items, name, spec)
    engine = MiningEngine(**_placement(args), snapshot_dir=args.snapshot_dir)
    if args.sweep:
        fracs = [float(s) for s in args.sweep.split(",")]
        results = engine.sweep(rows, n_items, spec, fracs)
        plan = (f"shared prep x{engine.stats['prepares']}" if engine.stats["prepares"]
                else "per-request path")
        print(f"{name}: {len(rows)} tx, sweep over min_sup={fracs} ({plan})")
        for frac, res in zip(fracs, results):
            tag = " [shared prep]" if res.prep_shared else ""
            print(f"  min_sup={frac:g} -> {res.summary()}{tag}")
        if args.tune or args.expect_plans:
            _report_plans(engine, args.expect_plans)
        return results
    res = engine.submit(rows, n_items, spec)
    print(f"{name}: {len(rows)} tx, min_count={res.min_count} -> {res.summary()}")
    for items, sup in res.top(args.top):
        print(f"  {items}: {sup}")
    if args.tune or args.expect_plans:
        _report_plans(engine, args.expect_plans)
    return res


if __name__ == "__main__":
    main()
