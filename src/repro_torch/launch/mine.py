"""Mining launcher for the port (one-shot mines):

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom --scale 1.0 --min-sup 0.15
    PYTHONPATH=src python -m repro_torch.launch.mine --algo prepost --dataset chess --min-sup 0.8
    PYTHONPATH=src python -m repro_torch.launch.mine --dataset chess --scale 0.1 --device cpu

``hprepost`` runs on the CUDA device unless ``--device cpu`` is given,
which runs every kernel's plain PyTorch version on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.data import synth
from repro_torch.mining import MineSpec, list_miners, mine
from repro_torch.mining.tune import registered_backends


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="hprepost", choices=list_miners())
    ap.add_argument("--dataset", default="mushroom", choices=list(synth.FIMI_SURROGATES))
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--min-sup", type=float, default=0.01)
    ap.add_argument("--max-k", type=int, default=5)
    ap.add_argument("--top", type=int, default=10)
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
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    rows, n_items = synth.load(args.dataset, scale=args.scale)
    spec = MineSpec(
        algorithm=args.algo, min_sup=args.min_sup, max_k=args.max_k,
        backend=args.backend, early_stop=not args.no_early_stop,
    )
    res = mine(rows, n_items, spec, device=args.device)
    print(f"{args.dataset}: {len(rows)} tx, min_count={res.min_count} -> {res.summary()}")
    for items, sup in res.top(args.top):
        print(f"  {items}: {sup}")
    return res


if __name__ == "__main__":
    main()
