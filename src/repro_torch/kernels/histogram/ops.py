"""Public op: item_histogram — the Job-1 weighted item count, with the
backend checked against the rows' device through the registry in
``repro_torch.mining.tune``: the CUDA kernel for CUDA rows at any universe
size, its plain ``scatter_add_`` version for CPU rows. ``histogram_cost``
counts one launch's work for the roofline (``repro_torch.launch.cost``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.histogram.kernel import histogram_cuda


def item_histogram(
    rows: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    n_bins: int,
    backend: str = "auto",
) -> torch.Tensor:
    """Weighted count of transactions containing each item id in [0, n_bins)."""
    from repro_torch.mining.tune import check_backend, resolve_backend

    check_backend(resolve_backend(backend, rows.device.type), rows)
    if weights is None:
        weights = torch.ones(rows.shape[0], dtype=torch.int32, device=rows.device)
    return histogram_cuda(rows, weights, n_bins=n_bins)


def histogram_cost(rows: torch.Tensor, weights: torch.Tensor, *, n_bins: int) -> tuple[int, int]:
    """(bytes, scalar operations) of one B3 launch: the rows and weights
    read once, the ``n_bins`` counts written once, one update a row slot."""
    R, L = rows.shape
    return R * L * 4 + R * 4 + n_bins * 4, R * L
