"""Public ops: ``nlist_wave`` — one mining wave, its operands read by index
from the N-list planes and the previous states (the miner's entry) — and
``nlist_intersect`` — the same fused intersect + support on rows the caller
has gathered (the JAX package's signature). The backend is checked against
the tensors' device through the registry in ``repro_torch.mining.tune``.
Both return ``(merged, supports)``:
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
    nlist_wave_cuda,
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


def nlist_wave(
    planes: torch.Tensor,
    prev_state: torch.Tensor,
    idx: torch.Tensor,
    n_live: int,
    *,
    backend: str = "auto",
    la_block: int = 512,
    early_stop: bool = False,
    min_count: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One wave: ``planes`` (3, K, W), ``prev_state`` (Cprev, W), ``idx``
    (3, Cpad) int64 rows (parent, base, extension) -> ``(new_state (Cpad, W),
    supports (Cpad,))``; rows ``>= n_live`` are zero. See
    ``kernel.nlist_wave_cuda``."""
    from repro_torch.mining.tune import check_backend, resolve_backend

    check_backend(resolve_backend(backend, planes.device.type), planes)
    return nlist_wave_cuda(planes, prev_state, idx, n_live, early_stop=early_stop,
                           min_count=min_count, la_block=la_block)
