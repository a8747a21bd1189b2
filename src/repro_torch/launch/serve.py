"""Serving launcher: batched greedy generation with the static-cache engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b --reduced --device cpu

Without ``--device`` it runs on the CUDA device and raises where there is
none.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models.common import init_params
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Greedy generation with random weights drawn from a torch.Generator seeded "
                    "with 0. The prompts are the JAX launcher's (numpy default_rng(0)), but its "
                    "weights come from JAX's PRNGKey(0), so the tokens differ from its output.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = params_from_reference(cfg, init_params(build_model(cfg).param_specs(), gen))
    eng = Engine(cfg, params, batch_size=args.batch, max_seq=args.max_seq, device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rng.integers(1, cfg.vocab_size, size=rng.integers(4, 24)).astype(np.int32),
                max_new=args.max_new)
        for _ in range(args.requests)
    ]
    done = []
    for i in range(0, len(reqs), args.batch):
        done += eng.generate(reqs[i:i + args.batch])
    for i, r in enumerate(done):
        print(f"req{i}: prompt[{len(r.prompt)}] -> {r.out}")
    return done


if __name__ == "__main__":
    main()
