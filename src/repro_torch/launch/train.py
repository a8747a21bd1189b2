"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --reduced --steps 20 --device cpu

Trains a config on one torch device: CUDA unless ``--device`` names another
(it raises where there is no CUDA device). ``--mesh DxM`` (or ``PxDxM``)
trains on a mesh, as the reference's ``--mesh``: ``MeshRules`` over
``make_mesh_from_spec``, the moments split ZeRO-1 over the data positions,
the rest on the mesh's first device. With ``--device`` every position is
that device (``--device cpu --mesh 4x2`` runs on the host, ``--device
cuda:0 --mesh 8x1`` on one card); without it the mesh takes one CUDA
device a position and raises where there are fewer. ``--ckpt-dir``
defaults to a directory under the system's temporary directory; a run
resumes from the latest checkpoint found there.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.data import corpus
from repro_torch.fault.failures import FailureInjector
from repro_torch.launch.mesh import make_mesh_from_spec
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import MeshRules
from repro_torch.training.optim import OptConfig
from repro_torch.training.step import TrainConfig
from repro_torch.training.trainer import LoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="tiny family-preserving config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--mesh", default=None, help="e.g. 4x2: data x model positions (ZeRO-1 moments over data)")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    rules = None
    if args.mesh:
        devices = None
        if args.device is not None:
            devices = [args.device] * math.prod(int(x) for x in args.mesh.split("x"))
        rules = MeshRules(make_mesh_from_spec(args.mesh, devices))

    toks = corpus.token_stream(2_000_000, cfg.vocab_size, seed=0)

    def batches():
        gen = corpus.batches(toks, args.batch, args.seq, seed=0)
        if cfg.family == "vlm":
            P = cfg.frontend_tokens

            def wrap():
                for b in gen:
                    b["patches"] = np.zeros((args.batch, P, cfg.d_model), np.float32)
                    yield b
            return wrap()
        if cfg.family == "encdec":
            def wrap():
                for b in gen:
                    b["frames"] = np.zeros((args.batch, max(args.seq // 4, 1), cfg.d_model), np.float32)
                    yield b
            return wrap()
        return gen

    injector = (
        FailureInjector(fail_at_steps=(args.inject_failure_at,))
        if args.inject_failure_at is not None
        else None
    )
    trainer = Trainer(
        model,
        TrainConfig(
            opt=OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1), total_steps=args.steps),
            compression=args.compression,
        ),
        LoopConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
            log_every=max(args.steps // 20, 1),
        ),
        batches,
        rules=rules,
        failure_injector=injector,
        device=None if rules is not None else args.device,
    )
    final = trainer.train()
    hist = trainer.history
    print(f"finished at step {final}; loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    for h in hist[:: max(len(hist) // 10, 1)]:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} ({h['dt']*1e3:.0f} ms)")
    return hist


if __name__ == "__main__":
    main()
