"""The plain reference: a levelwise frequent-itemset miner over vertical
bitsets, in NumPy.

It works from the rows alone: it counts the items, keeps the frequent
ones, builds one bitset per frequent item over the rows, and then, level
by level, joins two frequent k-itemsets that share their first k-1 items
and counts the join's support as the popcount of the AND of its prefix's
bitset and its last item's. It shares no code and no intermediate result
with the program under test.

``mine(rows, n_items, min_count)`` -> ``{sorted item-id tuple: support}``:
every itemset whose support (the number of rows holding all its items) is
at least ``min_count``, each with its exact support. Rows are an (R, L)
integer matrix, negative entries padding; a repeated item in a row counts
once.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as np


def min_count_of(min_sup, n_rows: int) -> int:
    """The least support that meets ``min_sup`` as a share of ``n_rows``:
    ceil(min_sup * n_rows), with ``min_sup`` read as the decimal it is
    written as (0.0125 is 1/80, not the float nearest it)."""
    return max(1, math.ceil(Fraction(str(min_sup)) * n_rows))


def _popcount_rows(words: np.ndarray) -> np.ndarray:
    """Bits set in each row of a (n, w) uint64 matrix."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    table = np.array([bin(i).count("1") for i in range(256)], np.int64)
    return table[words.view(np.uint8)].sum(axis=1)


def item_bitsets(rows: np.ndarray, items: np.ndarray) -> np.ndarray:
    """(len(items), ceil(R/64)) uint64: bit r of row j is set where row r
    holds ``items[j]``."""
    R = rows.shape[0]
    slot = np.full(int(rows.max(initial=-1)) + 1, -1, np.int64)
    slot[items] = np.arange(len(items))
    r, c = np.nonzero(rows >= 0)
    j = slot[rows[r, c]]
    keep = j >= 0
    dense = np.zeros((len(items), -(-R // 64) * 64), bool)
    dense[j[keep], r[keep]] = True
    return np.packbits(dense, axis=1, bitorder="little").view(np.uint64)


def mine(rows: np.ndarray, n_items: int, min_count: int) -> dict[tuple[int, ...], int]:
    rows = np.asarray(rows)
    valid = rows >= 0
    if (rows[valid] >= n_items).any():
        raise ValueError("an item id is at or past n_items")
    # each (row, item) once, then the items' supports
    r, c = np.nonzero(valid)
    pairs = np.unique(r.astype(np.int64) * n_items + rows[r, c])
    support = np.bincount(pairs % n_items, minlength=n_items)
    items = np.flatnonzero(support >= min_count)
    out = {(int(i),): int(support[i]) for i in items}
    if len(items) < 2:
        return out
    bits = item_bitsets(rows, items)
    # one level: frequent itemsets as (k,) arrays of positions into
    # ``items`` (ascending), with their bitsets
    level = np.arange(len(items))[:, None]
    level_bits = bits
    while len(level) > 1:
        new_sets, new_bits = [], []
        # itemsets sharing all but their last item are consecutive
        prefix_ends = np.flatnonzero(
            np.any(level[1:, :-1] != level[:-1, :-1], axis=1)) + 1
        for lo, hi in zip(np.r_[0, prefix_ends], np.r_[prefix_ends, len(level)]):
            for a in range(lo, hi - 1):
                last = level[a + 1:hi, -1]
                joined = level_bits[a][None, :] & bits[last]
                sup = _popcount_rows(joined)
                ok = sup >= min_count
                if not ok.any():
                    continue
                cand = np.concatenate(
                    [np.repeat(level[a][None, :], ok.sum(), axis=0), last[ok][:, None]], axis=1)
                new_sets.append(cand)
                new_bits.append(joined[ok])
                for s, v in zip(items[cand].tolist(), sup[ok].tolist()):
                    out[tuple(sorted(s))] = int(v)
        if not new_sets:
            break
        level = np.concatenate(new_sets)
        level_bits = np.concatenate(new_bits)
    return out


def at_threshold(found: dict, min_count: int) -> dict:
    """The itemsets of ``found`` (mined at a lower or equal threshold) whose
    support meets ``min_count``."""
    return {k: v for k, v in found.items() if v >= min_count}
