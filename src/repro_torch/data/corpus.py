"""Synthetic LM corpus + the bridge to the paper's miner.

``token_stream``: seeded Zipf-ish token sequences with injected frequent
n-gram "phrases" — gives the language-model trainer data and gives the
frequent-itemset miner real structure to find (the injected phrases come
back out as high-support itemsets; tested).

``ngram_transactions``: sliding windows of the corpus as transactions —
the data-pipeline integration point for HPrepost (corpus pattern mining).
"""
from __future__ import annotations

import numpy as np


def token_stream(
    n_tokens: int,
    vocab: int,
    *,
    seed: int = 0,
    n_phrases: int = 8,
    phrase_len: int = 4,
    phrase_rate: float = 0.15,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Zipf-ish unigram distribution over the vocab
    base = rng.zipf(1.3, size=int(n_tokens * 1.5)) % vocab
    phrases = rng.integers(0, vocab, size=(n_phrases, phrase_len))
    out = np.empty(n_tokens + phrase_len, np.int32)
    i = 0
    j = 0
    while i < n_tokens:
        if rng.random() < phrase_rate:
            p = phrases[rng.integers(n_phrases)]
            out[i : i + phrase_len] = p
            i += phrase_len
        else:
            out[i] = base[j]
            i += 1
            j += 1
    return out[:n_tokens]


def batches(tokens: np.ndarray, batch: int, seq: int, *, seed: int = 0):
    """Yield {"tokens": (batch, seq+1)} windows forever (seeded)."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        yield {"tokens": np.stack([tokens[s : s + seq + 1] for s in starts]).astype(np.int32)}


def ngram_transactions(tokens: np.ndarray, window: int = 8, stride: int = 4) -> np.ndarray:
    """Sliding windows as transactions (duplicate items collapse)."""
    n = (len(tokens) - window) // stride
    idx = np.arange(window)[None, :] + stride * np.arange(n)[:, None]
    rows = tokens[idx].astype(np.int32)
    rows.sort(axis=1)
    dup = np.zeros_like(rows, bool)
    dup[:, 1:] = rows[:, 1:] == rows[:, :-1]
    rows[dup] = -1
    rows.sort(axis=1)  # PAD (-1) slots end up in front; encoding handles both
    return rows
