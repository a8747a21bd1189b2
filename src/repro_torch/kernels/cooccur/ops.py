"""Public op: cooccurrence_matrix — the F2 scan, with the backend checked
against the rows' device through the registry in
``repro_torch.mining.tune``: the CUDA kernel for CUDA rows (the one-hot
product on the int8 tensor cores, exact in int32, no 2^24 chunking
needed), its plain pair scatter for CPU rows."""
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
