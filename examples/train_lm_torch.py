"""End-to-end training on the PyTorch port, the twin of
``examples/train_lm.py``: a small LM for a few hundred steps, with
checkpointing and an injected failure + automatic restart.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]

Trains on ``--device`` (CUDA by default, raising without one).
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_example"))
    args = ap.parse_args()
    hist = train_main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", str(max(1, min(50, args.steps // 4))),
        "--inject-failure-at", str(args.steps // 2),  # survives a mid-run failure
        "--device", args.device,
    ])
    assert hist[-1]["loss"] < hist[0]["loss"], "loss must improve"
    print("OK: loss improved and the run survived an injected failure.")
