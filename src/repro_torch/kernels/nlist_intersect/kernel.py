"""Wrappers of the hand-written CUDA wave kernels (``csrc/nlist_intersect.cu``):
B1 (replaces the TPU kernel
``repro/kernels/nlist_intersect/kernel.py:_intersect_kernel``) and B2, its
early-stop twin (replaces ``_intersect_es_kernel``). Both are one template
behind one launcher, ``nlist_wave_launch``, reached three ways:

- ``nlist_wave_cuda``: the miner's wave. It reads each candidate's operands
  in place from the ``(3, K, W)`` N-list planes and the previous wave's
  states by the wave's ``(3, Cpad)`` index rows — no gathered copies;
- ``nlist_intersect_cuda`` (B1) and ``nlist_intersect_es_cuda`` (B2): the
  JAX-shaped ops on ``(B, La)`` / ``(B, Ly)`` rows, launched with identity
  row indices.

Each takes its plain version (``ref.py``) for CPU tensors and launches the
kernel for CUDA tensors. Launches count on ``nlist_intersect_cuda.launches``
(B1) and ``nlist_intersect_es_cuda.launches`` (B2), whichever entry made
them. Counts accumulate in int32 and are exact below 2^31 (the miner guards
the row count against that bound). Either route charges ``ops.wave_cost``
(the wave entry) or ``ops.intersect_cost`` to an active cost recorder."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.nlist_intersect.ref import (
    nlist_intersect_fused_ref,
    nlist_intersect_masked_ref,
    nlist_wave_ref,
)
from repro_torch.launch import cost

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "nlist_wave_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I, _LL,
                          _P, _P, _P],
}


def _launch(masked, ptrs, B, La, Ly, n_live, la_block, min_count, device):
    """``ptrs``: device addresses (int, 0 = none) of a_pre, a_post, a_cnt,
    a_idx, y_pre, y_post, y_idx, y_cnt, c_idx, in the launcher's order."""
    out = torch.empty((B, La), dtype=torch.int32, device=device)
    sup = torch.empty(B, dtype=torch.int32, device=device)
    lib = _cuda.library("nlist_intersect", _SIGNATURES)
    with torch.cuda.device(device):
        rc = lib.nlist_wave_launch(
            *ptrs, B, La, Ly, n_live, int(masked), max(1, min(int(la_block), max(La, 1))),
            int(min_count), out.data_ptr(), sup.data_ptr(), _cuda.stream_of(out),
        )
    _cuda.check_launch(rc, "nlist_intersect_es" if masked else "nlist_intersect")
    _cuda.count_launch(nlist_intersect_es_cuda if masked else nlist_intersect_cuda)
    return out, sup


def _check(a_pre, a_post, y_pre, y_post, y_cnt, a_cnt=None):
    B, La = a_pre.shape
    Ly = y_pre.shape[1]
    for name, t in (("a_pre", a_pre), ("a_post", a_post), ("a_cnt", a_cnt)):
        if t is not None:
            _cuda.check_tensor(t, name, torch.int32, (B, La))
    for name, t in (("y_pre", y_pre), ("y_post", y_post), ("y_cnt", y_cnt)):
        _cuda.check_tensor(t, name, torch.int32, (B, Ly))
    return B, La, Ly


def _wave_cost(*args, **kw):
    from repro_torch.kernels.nlist_intersect.ops import wave_cost

    return wave_cost(*args, **kw)


def _b1_cost(a_pre, a_post, y_pre, *args):
    from repro_torch.kernels.nlist_intersect.ops import intersect_cost

    return intersect_cost(a_pre, y_pre)


def _b2_cost(a_pre, a_post, a_cnt, y_pre, *args, **kw):
    from repro_torch.kernels.nlist_intersect.ops import intersect_cost

    return intersect_cost(a_pre, y_pre, a_cnt=True)


@cost.charged(_b1_cost)
def nlist_intersect_cuda(a_pre, a_post, y_pre, y_post, y_cnt):
    """B1: ``(merged (B, La) int32, supports (B,) int32)``. Both lists must
    be pre-ascending (N-lists are) up to their padding: a slot whose pre is
    INT32_MAX is padding, a suffix of each list, and merges into no A slot
    whatever post and count it carries (``core.nlist.intersect_torch``)."""
    if a_pre.device.type == "cpu":
        return nlist_intersect_fused_ref(a_pre, a_post, y_pre, y_post, y_cnt)
    B, La, Ly = _check(a_pre, a_post, y_pre, y_post, y_cnt)
    ptrs = (a_pre.data_ptr(), a_post.data_ptr(), 0, 0, y_pre.data_ptr(), y_post.data_ptr(), 0,
            y_cnt.data_ptr(), 0)
    return _launch(False, ptrs, B, La, Ly, B, La, 0, a_pre.device)


@cost.charged(_b2_cost)
def nlist_intersect_es_cuda(a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, min_count, *,
                            la_block=512):
    """B2: B1 with tile-order early stop at ``min_count`` (see
    ``ref.nlist_intersect_masked_ref``, which it reproduces exactly, the
    padding contract included: A's padding counts weigh nothing)."""
    if a_pre.device.type == "cpu":
        return nlist_intersect_masked_ref(
            a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, min_count, la_block=la_block)
    B, La, Ly = _check(a_pre, a_post, y_pre, y_post, y_cnt, a_cnt)
    ptrs = (a_pre.data_ptr(), a_post.data_ptr(), a_cnt.data_ptr(), 0, y_pre.data_ptr(),
            y_post.data_ptr(), 0, y_cnt.data_ptr(), 0)
    return _launch(True, ptrs, B, La, Ly, B, la_block, min_count, a_pre.device)


@cost.charged(_wave_cost)
def nlist_wave_cuda(planes, prev_state, idx, n_live, *, early_stop=False, min_count=0,
                    la_block=512):
    """One wave, gather fused: candidate ``b < n_live`` intersects extension
    item ``idx[2, b]`` (A: ``planes[:, idx[2, b]]``) with base item
    ``idx[1, b]`` (Y pre/post: ``planes[:2, idx[1, b]]``) weighted by its
    parent's state ``prev_state[idx[0, b]]``; B2 (``early_stop``) or B1.
    ``planes`` (3, K, W) int32, ``prev_state`` (Cprev, W) int32, ``idx``
    (3, Cpad) int64 -> ``(new_state (Cpad, W) int32, sup (Cpad,) int32)``,
    rows ``>= n_live`` zero. Indices must lie inside ``planes``/``prev_state``.
    Padding slots (pre INT32_MAX) merge nothing whatever ``prev_state`` holds
    there, and under early stop their ``planes[2]`` counts add nothing to
    the liveness mass (``ref.first_dead_slot``)."""
    if planes.device.type == "cpu":
        return nlist_wave_ref(planes, prev_state, idx, n_live, early_stop=early_stop,
                              min_count=min_count, la_block=la_block)
    _, K, W = planes.shape
    Cpad = idx.shape[1]
    _cuda.check_tensor(planes, "planes", torch.int32, (3, K, W))
    _cuda.check_tensor(prev_state, "prev_state", torch.int32, (prev_state.shape[0], W))
    _cuda.check_tensor(idx, "idx", torch.int64, (3, Cpad))
    if not 0 <= n_live <= Cpad:
        raise ValueError(f"n_live must lie in [0, {Cpad}], got {n_live}")
    # rows of planes and idx by address: plane k starts k*K*W int32 in,
    # index row r at r*Cpad int64
    pre, plane = planes.data_ptr(), K * W * 4
    ix, row = idx.data_ptr(), Cpad * 8
    ptrs = (pre, pre + plane, pre + 2 * plane if early_stop else 0, ix + 2 * row,
            pre, pre + plane, ix + row, prev_state.data_ptr(), ix)
    return _launch(bool(early_stop), ptrs, Cpad, W, W, int(n_live), la_block,
                   min_count if early_stop else 0, planes.device)


nlist_intersect_cuda.launches = 0
nlist_intersect_es_cuda.launches = 0
