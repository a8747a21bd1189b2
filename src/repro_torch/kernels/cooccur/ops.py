"""Public op: cooccurrence_matrix — the F2 scan, with the backend checked
against the rows' device through the registry in
``repro_torch.mining.tune``: the CUDA kernel for CUDA rows (the one-hot
product on the int8 tensor cores, exact in int32, no 2^24 chunking
needed), its plain pair scatter for CPU rows. ``cooccur_cost`` counts one
launch's work for the roofline (``repro_torch.launch.cost``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cooccur.kernel import cooccur_cuda


def cooccurrence_matrix(
    rows: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    n_items: int,
    backend: str = "auto",
) -> torch.Tensor:
    from repro_torch.mining.tune import check_backend, resolve_backend

    check_backend(resolve_backend(backend, rows.device.type), rows)
    if weights is None:
        weights = torch.ones(rows.shape[0], dtype=torch.int32, device=rows.device)
    return cooccur_cuda(rows, weights, n_items=n_items)


def cooccur_cost(rows: torch.Tensor, weights: torch.Tensor, *, n_items: int) -> tuple[int, int]:
    """(bytes, scalar operations) of one B4 launch: the rank rows and
    weights read once, the (K, K) matrix written once, and one update for
    each ordered pair of valid slots in a row (Σ over rows of its valid
    slots squared: what this data needs)."""
    R, L = rows.shape
    nvalid = (rows >= 0).sum(1).to(torch.int64)
    return R * L * 4 + R * 4 + n_items * n_items * 4, int((nvalid * nvalid).sum())
