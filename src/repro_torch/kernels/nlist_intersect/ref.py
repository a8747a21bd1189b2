"""Plain PyTorch versions of the wave kernels B1/B2: the batched
searchsorted N-list intersection with its fused support, and a vectorised
model of the early-stop twin's tile-order masking. They run on any device;
the wrappers in ``kernel.py`` take them only for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.core.nlist import INF, intersect_torch


def nlist_intersect_fused_ref(a_pre, a_post, y_pre, y_post, y_cnt):
    """(merged (B, La) int32, supports (B,) int32): the B1 contract,
    padding masked (``intersect_torch``)."""
    merged = intersect_torch(a_pre, a_post, y_pre, y_post, y_cnt)
    return merged.to(torch.int32), merged.sum(dim=1).to(torch.int32)


def nlist_intersect_masked_ref(
    a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, min_count, *, la_block=512
):
    """The B2 contract: scan A-row tiles of ``la_block`` slots in order;
    before each tile a candidate is alive iff support-so-far plus the
    inclusive A-count suffix mass of the remaining tiles can still reach
    ``min_count``; dead candidates' tiles are zeroed and their support
    frozen. ``min_count <= 0`` reproduces the exact path. Padding slots
    (pre = INT32_MAX) merge nothing and weigh nothing, whatever their counts.

    Death is monotone (a dead candidate's support stops growing while the
    suffix mass only shrinks), so the first dead tile is the first tile
    where the all-alive prefix sum plus the suffix mass misses the
    threshold — no loop over tiles."""
    exact = intersect_torch(a_pre, a_post, y_pre, y_post, y_cnt)  # int64
    La = exact.shape[1]
    dead_at = first_dead_slot(exact, a_pre, a_cnt, min_count, la_block)
    keep = torch.arange(La, device=exact.device) < dead_at[:, None]
    merged = exact * keep
    return merged.to(torch.int32), merged.sum(dim=1).to(torch.int32)


def first_dead_slot(exact, a_pre, a_cnt, min_count, la_block):
    """(B,) int64: where B2's rule zeroes each candidate's row from — the
    first slot of its first dead ``la_block`` tile, or La if it never dies —
    given the exact merged row (B1's) and A's pre and counts. Only A's valid
    slots (pre != INT32_MAX) weigh in the liveness mass."""
    B, La = exact.shape
    lab = max(1, min(int(la_block), La))
    nt = (La + lab - 1) // lab
    pad = nt * lab - La

    def tiles(x):
        return torch.nn.functional.pad(x.to(torch.int64), (0, pad)).reshape(B, nt, lab).sum(2)

    tsum, mass = tiles(exact), tiles(torch.where(a_pre != INF, a_cnt, 0))
    rem = torch.flip(torch.cumsum(torch.flip(mass, [1]), 1), [1])  # inclusive suffix
    before = torch.cumsum(tsum, 1) - tsum  # support before each tile if all alive
    dead = torch.cummax((before + rem < int(min_count)).to(torch.int32), dim=1).values.bool()
    return torch.clamp((~dead).sum(1) * lab, max=La)


def nlist_wave_ref(planes, prev_state, idx, n_live, *, early_stop=False, min_count=0,
                   la_block=512):
    """The wave entry's contract: gather each candidate's operands —
    A = ``planes[:, idx[2]]``, Y pre/post = ``planes[:2, idx[1]]``, Y counts
    = ``prev_state[idx[0]]`` — then B2 (``early_stop``) or B1 on them; rows
    ``>= n_live`` are zero, and padding slots of the N-lists merge and weigh
    nothing, whatever the state or the count plane holds there.
    -> ``(new_state (Cpad, W), sup (Cpad,))`` int32."""
    a = planes[:, idx[2]]
    y = planes[:2, idx[1]]
    state = prev_state[idx[0]]
    if early_stop:
        new, sup = nlist_intersect_masked_ref(a[0], a[1], a[2], y[0], y[1], state, min_count,
                                              la_block=la_block)
    else:
        new, sup = nlist_intersect_fused_ref(a[0], a[1], y[0], y[1], state)
    new[n_live:] = 0
    sup[n_live:] = 0
    return new, sup
