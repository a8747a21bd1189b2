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

``wave_cost`` and ``intersect_cost`` count one launch's work for the
roofline (``repro_torch.launch.cost``).
"""
from __future__ import annotations

import math

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


def wave_cost(planes: torch.Tensor, state: torch.Tensor, idx: torch.Tensor, n_live: int, *,
              early_stop: bool = False, min_count: int = 0, la_block: int = 512) -> tuple[int, int]:
    """(bytes, scalar operations) of one ``nlist_wave`` launch, as far as
    this wave's data needs them, each input read once and each output
    written once.

    Padding (pre = INT32_MAX) is a suffix and merges and weighs nothing,
    whatever counts it carries (the kernels' padding contract, see
    ``core.nlist.intersect_torch``), so candidate b needs its A
    pre/post (extension item's row) up to slot p_b: under early stop
    (B2) its first dead slot (``ref.first_dead_slot`` on B1's exact rows),
    else its valid length; under early stop also its A counts up to the
    valid length (the liveness rule needs their suffix mass). It needs the
    counts (parent's state row) of the Y codes whose only possible ancestor
    lies before p_b, and their pre/post (base item's row) where the count is
    nonzero. A row that several candidates read counts once, as does
    ``planes[2]`` when ``state`` is that plane. Every slot's merged row and
    support is written, and the live index columns are read. Each nonzero Y
    code costs a binary search over the W slots plus two updates."""
    from repro_torch.kernels.nlist_intersect.ref import first_dead_slot, nlist_wave_ref

    K, W = planes.shape[1], planes.shape[2]
    B = idx.shape[1]
    live = idx[:, :n_live]
    stop = None
    if early_stop:
        exact = nlist_wave_ref(planes, state, idx, n_live)[0][:n_live]
        stop = first_dead_slot(exact, planes[0][live[2]], planes[2][live[2]], min_count, la_block)
    pad = torch.iinfo(torch.int32).max
    lens = (planes[0] != pad).sum(1)
    na, ny = lens[live[2]], lens[live[1]]
    a_pre, y_pre = planes[0][live[2]], planes[0][live[1]]
    p = na if stop is None else torch.minimum(stop.to(na.dtype), na)
    # Y codes with y_pre <= a_pre[p] have their ancestor before slot p
    top = a_pre.gather(1, p.clamp(max=W - 1)[:, None])[:, 0]
    thr = torch.where(p < na, top, pad)
    my = torch.minimum(torch.searchsorted(y_pre, thr[:, None].contiguous(), right=True)[:, 0], ny)
    cols = torch.arange(W, device=idx.device)
    y_need = cols < my[:, None]
    y_nz = (state[live[0]] != 0) & y_need

    def union(n_rows, rows, mask):  # (n_rows, W): slots some candidate needs
        hits = torch.zeros((n_rows, W), dtype=torch.int32, device=idx.device)
        return hits.index_add_(0, rows, mask.to(torch.int32)) > 0

    pre_post = union(K, live[2], cols < p[:, None]) | union(K, live[1], y_nz)
    counts = union(state.shape[0], live[0], y_need)
    a_cnt = union(K, live[2], cols < na[:, None]) if stop is not None else torch.zeros_like(pre_post)
    if state.data_ptr() == planes[2].data_ptr() and state.shape == planes[2].shape:
        n_cnt = int((counts | a_cnt).sum())
    else:
        n_cnt = int(counts.sum()) + int(a_cnt.sum())
    n = 8 * int(pre_post.sum()) + 4 * n_cnt + B * W * 4 + B * 4 + 3 * n_live * 8
    nz = int(y_nz.sum())
    return n, nz * (math.ceil(math.log2(W)) + 2)


def intersect_cost(a_pre: torch.Tensor, y_pre: torch.Tensor, *, a_cnt: bool = False) -> tuple[int, int]:
    """(bytes, scalar operations) of one ``nlist_intersect`` launch on rows
    the caller gathered: each of them read whole once (A pre/post, with
    ``a_cnt`` its counts, and Y pre/post/counts), the merged rows and
    supports written once, and for every valid Y code a binary search over
    La slots plus two updates."""
    B, La = a_pre.shape
    Ly = y_pre.shape[1]
    n = B * La * 4 * (3 if a_cnt else 2) + B * Ly * 4 * 3 + B * La * 4 + B * 4
    ny = int((y_pre != torch.iinfo(torch.int32).max).sum())
    return n, ny * (math.ceil(math.log2(max(La, 2))) + 2)
