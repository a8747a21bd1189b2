"""Batched serving on the PyTorch port: prefill + greedy decode over a
static KV cache, the twin of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Serves on ``--device`` (CUDA by default, raising without one).
"""
import argparse

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = serve_main(["--arch", "qwen1_5_0_5b", "--reduced", "--batch", "4",
                      "--max-seq", "96", "--max-new", "12", "--requests", "6",
                      "--device", args.device])
    assert all(len(r.out) == 12 for r in out)
    print("OK: 6 requests served in 2 static-batch waves.")
