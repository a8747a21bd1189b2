"""Mining launcher for the port (the paper's pipeline as a CLI):

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom --scale 1.0 --min-sup 0.15
    PYTHONPATH=src python -m repro_torch.launch.mine --algo fpgrowth --dataset chess --min-sup 0.8
    PYTHONPATH=src python -m repro_torch.launch.mine --corpus --vocab 1024 --min-sup 0.02
    PYTHONPATH=src python -m repro_torch.launch.mine --dataset chess --scale 0.1 --device cpu

``hprepost`` runs on the CUDA device unless ``--device cpu`` is given,
which runs every kernel's plain PyTorch version on the CPU.

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
"""
from __future__ import annotations

import argparse

from repro_torch.data import corpus, synth
from repro_torch.mining import MineSpec, MiningEngine, list_miners
from repro_torch.mining.tune import registered_backends


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
    args = ap.parse_args(argv)
    if args.expect_plans and not args.tune:
        ap.error("--expect-plans needs --tune")

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
    engine = MiningEngine(device=args.device, snapshot_dir=args.snapshot_dir)
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
