"""Plain PyTorch version of the co-occurrence kernel B4: a pair scatter,
``C[v1, v2] += w_r`` for every ordered pair of valid slots of a row, in row
chunks that bound the (rows, L, L) pair tensor. Exact int64 arithmetic,
cast to int32 like the reference's output."""
from __future__ import annotations

import torch

# pairs materialised per chunk of rows
CHUNK_PAIRS = 1 << 24


def cooccur_ref(rows: torch.Tensor, weights: torch.Tensor, *, n_items: int) -> torch.Tensor:
    """(K, K) int32 with K = n_items: C[i, j] = sum_r w_r * cnt_r(i) * cnt_r(j)."""
    R, L = rows.shape
    K = n_items
    C = torch.zeros(K * K, dtype=torch.int64, device=rows.device)
    step = max(1, CHUNK_PAIRS // max(L * L, 1))
    for s in range(0, R, step):
        r = rows[s : s + step].to(torch.int64)
        w = weights[s : s + step].to(torch.int64)
        ok = (r >= 0) & (r < K)
        pair_ok = ok[:, :, None] & ok[:, None, :]
        flat = (r[:, :, None] * K + r[:, None, :])[pair_ok]
        wp = w[:, None, None].expand(pair_ok.shape)[pair_ok]
        C.scatter_add_(0, flat, wp)
    return C.reshape(K, K).to(torch.int32)
