"""Synthetic transaction datasets (FIMI surrogates + IBM-Quest-style).

The paper evaluates on Chess / Mushroom / Pumsb / Kosarak from
http://fimi.ua.ac.be/data/. This container is offline, so we generate
surrogates matched on the paper's Table-3 characteristics (#items,
#transactions, avg length) and on the qualitative density profile
(dense grid-like rows for chess/mushroom/pumsb; sparse power-law for
kosarak). The substitution is recorded in EXPERIMENTS.md.

Generators are seeded and deterministic.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.encoding import pad_transactions


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_items: int
    n_tx: int
    avg_len: int
    kind: str  # "dense" | "sparse"
    max_len: int


# Scaled-down surrogates (same shape, ~1/4 the rows) so CPU benches finish;
# the full-size variants are available via scale=1.0.
FIMI_SURROGATES = {
    "chess": DatasetSpec("chess", 75, 3196, 37, "dense", 37),
    "mushroom": DatasetSpec("mushroom", 119, 8124, 23, "dense", 23),
    "pumsb": DatasetSpec("pumsb", 7117, 49046, 74, "dense", 74),
    "kosarak": DatasetSpec("kosarak", 41270, 990002, 8, "sparse", 48),
}


def generate_dense(
    spec: DatasetSpec, rng: np.random.Generator, n_tx: int, n_templates: int = 4, mutate: float = 0.25
) -> np.ndarray:
    """Chess/pumsb-like data: ``avg_len`` attribute slots, each holding one
    value of a small per-slot alphabet. Rows are noisy copies of a few
    *templates*, giving the strong item correlation (and the itemset-count
    explosion at low min-sup) the real FIMI dense datasets show."""
    n_slots = spec.avg_len
    vals_per_slot = max(2, spec.n_items // n_slots)
    templates = rng.integers(0, vals_per_slot, size=(n_templates, n_slots))
    which = rng.integers(0, n_templates, size=n_tx)
    rows = templates[which]
    flip = rng.random((n_tx, n_slots)) < mutate
    rows = np.where(flip, rng.integers(0, vals_per_slot, size=(n_tx, n_slots)), rows)
    base = (np.arange(n_slots) * vals_per_slot)[None, :]
    return (base + rows).astype(np.int32)  # fixed length: no PAD needed


def generate_sparse(spec: DatasetSpec, rng: np.random.Generator, n_tx: int) -> np.ndarray:
    """Kosarak-like: power-law item popularity, geometric row lengths."""
    lens = np.minimum(rng.geometric(1.0 / spec.avg_len, size=n_tx), spec.max_len)
    # Zipf item ids clipped to the universe
    total = int(lens.sum())
    items = rng.zipf(1.35, size=total * 2)
    items = items[items <= spec.n_items][:total].astype(np.int64) - 1
    while len(items) < total:  # top-up in the unlikely short case
        extra = rng.zipf(1.35, size=total)
        extra = extra[extra <= spec.n_items]
        items = np.concatenate([items, extra.astype(np.int64) - 1])[:total]
    out = np.full((n_tx, spec.max_len), -1, np.int32)
    off = 0
    starts = np.concatenate([[0], np.cumsum(lens)])
    for r in range(n_tx):
        seg = np.unique(items[starts[r] : starts[r + 1]])
        out[r, : len(seg)] = seg
        off += lens[r]
    return out


def load(name: str, *, scale: float = 0.25, seed: int = 0) -> tuple[np.ndarray, int]:
    """Return ``(rows, n_items)`` for a FIMI surrogate at ``scale`` of its rows."""
    spec = FIMI_SURROGATES[name]
    # stable per-dataset seed: builtin hash() is salted per process, which
    # would make "the same dataset" differ between two CLI invocations
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    n_tx = max(64, int(spec.n_tx * scale))
    if spec.kind == "dense":
        rows = generate_dense(spec, rng, n_tx)
    else:
        rows = generate_sparse(spec, rng, n_tx)
    return rows, spec.n_items


def random_db(rng: np.random.Generator, n_tx: int, n_items: int, max_len: int) -> np.ndarray:
    """Small random DB for property tests."""
    lens = rng.integers(0, max_len + 1, size=n_tx)
    tx = [rng.choice(n_items, size=l, replace=False) if l else [] for l in lens]
    return pad_transactions(tx, max_len=max(max_len, 1))
