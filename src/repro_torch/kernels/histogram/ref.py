"""Plain PyTorch version of the histogram kernel B3: a ``scatter_add_`` of
the row weights at every valid item id. It never builds a one-hot
(R, L, n_bins) tensor, so any universe size fits in memory."""
from __future__ import annotations

import torch


def histogram_ref(rows: torch.Tensor, weights: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """out[k] = sum_r w_r * #{c : rows[r, c] == k}; ids outside [0, n_bins)
    (PAD = -1) are ignored. int32, wrapping like the reference's int32 sums."""
    flat = rows.reshape(-1).to(torch.int64)
    w = weights.to(torch.int64)[:, None].expand(rows.shape).reshape(-1)
    ok = (flat >= 0) & (flat < n_bins)
    out = torch.zeros(n_bins, dtype=torch.int64, device=rows.device)
    return out.scatter_add_(0, flat[ok], w[ok]).to(torch.int32)
