"""The paper's technique as a data-pipeline feature: mine frequent token
n-gram itemsets from the LM training corpus with distributed HPrepost.

  PYTHONPATH=src python examples/mine_corpus_torch.py [--device cpu]

The twin of ``examples/mine_corpus.py`` on the PyTorch port: the mine runs on
``--device`` (CUDA by default, raising without one).

The synthetic corpus injects known 4-token phrases; the miner must surface
them as high-support 4-itemsets — the corpus-statistics workflow (vocabulary
analysis / data curation) this framework runs between training epochs. Runs
through a ``MiningEngine`` session, the shape production traffic uses.
"""
import argparse

from repro_torch.data import corpus
from repro_torch.mining import MineSpec, MiningEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
DEV = ap.parse_args().device

VOCAB = 512
toks = corpus.token_stream(120_000, VOCAB, seed=3, n_phrases=6, phrase_len=4, phrase_rate=0.2)
rows = corpus.ngram_transactions(toks, window=8, stride=4)
print(f"corpus: {len(toks)} tokens -> {len(rows)} window transactions")

engine = MiningEngine(device=DEV)  # default 1x1 (data, model) mesh; pass a mesh to scale
res = engine.submit(rows, VOCAB, MineSpec(algorithm="hprepost", min_sup=0.02, max_k=4))

four = res.by_size(4)
print(f"{res.summary()}; {len(four)} of size 4 — the injected phrases:")
for items, sup in sorted(four.items(), key=lambda kv: -kv[1])[:8]:
    print(f"  {items}: support {sup}")
assert len(four) >= 4, "expected the injected phrases to be recovered"
