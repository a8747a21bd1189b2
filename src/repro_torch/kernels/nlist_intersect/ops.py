"""Public op: nlist_intersect — the wave's fused intersect + support, with
the backend checked against the tensors' device through the registry in
``repro_torch.mining.tune``. Both paths return ``(merged, supports)``:
merged counts aligned with A's code slots plus their per-candidate row
sums, so the waves never re-read the merged state just to reduce it.

Early stopping: with ``early_stop=True`` (plus ``a_cnt`` and a
``min_count``) the op runs the masked twin B2, which zeroes candidates
whose support upper bound falls below ``min_count`` mid-scan; candidates
that reach ``min_count`` get exactly B1's values. Callers only enable it
where the supports it sees are final (one data shard, non-segmented);
``min_count <= 0`` disables masking.

Exactness bound: the CUDA kernels accumulate counts in int32, exact below
``EXACT_MAX = 2^31 - 1``. Every count is bounded by the shard's
transaction count, so ``HPrepostMiner.prepare`` refuses row counts at or
above it before any wave runs. (The reference's Pallas kernels accumulate
in fp32 and are bounded at 2^24 instead.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.nlist_intersect.kernel import (
    nlist_intersect_cuda,
    nlist_intersect_es_cuda,
)

# the port kernels' int32 accumulator: a possible count must stay below this
EXACT_MAX = (1 << 31) - 1


def nlist_intersect(
    a_pre: torch.Tensor,
    a_post: torch.Tensor,
    y_pre: torch.Tensor,
    y_post: torch.Tensor,
    y_cnt: torch.Tensor,
    *,
    a_cnt: torch.Tensor | None = None,
    backend: str = "auto",
    la_block: int = 512,
    early_stop: bool = False,
    min_count=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.mining.tune import check_backend, resolve_backend

    check_backend(resolve_backend(backend, a_pre.device.type), a_pre)
    if early_stop and a_cnt is not None and min_count is not None:
        return nlist_intersect_es_cuda(
            a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, min_count, la_block=la_block)
    return nlist_intersect_cuda(a_pre, a_post, y_pre, y_post, y_cnt)
