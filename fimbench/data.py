"""The benchmark's own surrogate generator of a sparse FIMI dataset.

The real files are not in the repository. The rows follow the port's sparse
surrogate (``repro_torch/data/synth.py`` as of the benchmark's first
version: Zipf item popularity, geometric row lengths), with two changes
that hold them to the source's shape: a row's length is the number of
distinct items it holds (the port draws a length and then deduplicates, so
its rows come out shorter than drawn), and that length is geometric with
the mean, after the cap, that the configuration states. They are drawn
with a ``torch.Generator`` on the card, in a few large calls.

A configuration file's ``dataset`` object holds the generator's
parameters: ``kind`` ``"sparse"``, ``n_items``, ``n_tx``, ``avg_len`` (the
rows' mean length, after the cap), ``max_len`` (the cap and the padded row
width) and ``zipf_a`` (the power law of item popularity, truncated to
``n_items``).

Rows are ``(n_tx, max_len)`` int32, items ascending in each row, ``-1``
padding.
"""
from __future__ import annotations

import zlib

import numpy as np

PAD = -1


def geometric_p(mean: float, cap: int) -> float:
    """The success probability p of a geometric length on {1, 2, ...} whose
    mean after capping at ``cap``, (1 - (1 - p)^cap) / p, is ``mean``."""
    if not 1 <= mean < cap:
        raise ValueError(f"a mean length of {mean} cannot be held under a cap of {cap}")
    lo, hi = 0.0, 1.0
    for _ in range(200):
        p = (lo + hi) / 2
        if (1 - (1 - p) ** cap) / p > mean:
            lo = p
        else:
            hi = p
    return (lo + hi) / 2


def distinct_prefix(draws, lens):
    """(n, M) bool: the first ``lens[i]`` distinct items of row i of
    ``draws`` (n, M), in draw order; fewer where the row holds fewer."""
    import torch

    order = torch.argsort(draws, dim=1, stable=True)
    s = torch.gather(draws, 1, order)
    first_sorted = torch.ones_like(s, dtype=torch.bool)
    first_sorted[:, 1:] = s[:, 1:] != s[:, :-1]
    first = torch.empty_like(first_sorted).scatter_(1, order, first_sorted)
    return first & (torch.cumsum(first, dim=1) <= lens[:, None])


def generate_sparse(ds: dict, seed: int, n_tx: int, device="cpu",
                    chunk: int = 1 << 18) -> np.ndarray:
    """Row lengths geometric with mean ``avg_len`` after the cap at
    ``max_len``; each row then takes that many distinct items, drawn from
    Zipf(``zipf_a``) truncated to ``n_items`` (by its inverse CDF) and
    repeats passed over, which is sampling without replacement in
    proportion to the law. Drawn on ``device`` in blocks of ``chunk`` rows;
    one seed gives one set of rows on one kind of device."""
    import torch

    n_items, max_len = ds["n_items"], ds["max_len"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    lens = torch.empty(n_tx, dtype=torch.float64, device=device)
    lens = lens.geometric_(geometric_p(ds["avg_len"], max_len), generator=g)
    lens = lens.clamp_(max=max_len).long()
    k = torch.arange(1, n_items + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(k ** -ds["zipf_a"], 0)
    cdf /= cdf[-1].clone()
    big = torch.iinfo(torch.int64).max
    per_round = 2 * max_len  # draws a row a round; about 1% of rows need a second
    out = np.empty((n_tx, max_len), np.int32)
    for lo in range(0, n_tx, chunk):
        want = lens[lo:min(lo + chunk, n_tx)]
        rows = torch.full((len(want), max_len), big, dtype=torch.int64, device=device)
        todo = torch.arange(len(want), device=device)
        draws = torch.empty((0, 0), dtype=torch.int64, device=device)
        while len(todo):
            u = torch.rand((len(todo), per_round), dtype=torch.float64, device=device, generator=g)
            new = torch.searchsorted(cdf, u).clamp_(max=n_items - 1)
            draws = torch.cat([draws, new], dim=1) if draws.numel() else new
            keep = distinct_prefix(draws, want[todo])
            done = keep.sum(dim=1) == want[todo]
            got = torch.sort(torch.where(keep, draws, big), dim=1).values[:, :max_len]
            rows[todo[done]] = got[done]
            todo, draws = todo[~done], draws[~done]
        out[lo:lo + len(want)] = torch.where(rows == big, PAD, rows).to(torch.int32).cpu().numpy()
    return out


def generate(name: str, ds: dict, seed: int, n_tx: int | None = None,
             device="cpu") -> np.ndarray:
    """The rows of dataset ``name`` (parameters ``ds``) under ``seed``, at
    ``n_tx`` rows (the dataset's own count when None), as host memory,
    drawn on ``device``; the seed is offset by a stable hash of the name."""
    n_tx = ds["n_tx"] if n_tx is None else n_tx
    if ds["kind"] != "sparse":
        raise ValueError(f"unknown dataset kind {ds['kind']!r}")
    return generate_sparse(ds, seed + zlib.crc32(name.encode()) % 2**16, n_tx, device)
