"""Wrappers of the hand-written CUDA wave kernels (``csrc/nlist_intersect.cu``):
B1 ``nlist_intersect_cuda`` (replaces the TPU kernel
``repro/kernels/nlist_intersect/kernel.py:_intersect_kernel``) and B2
``nlist_intersect_es_cuda`` (replaces ``_intersect_es_kernel``).

Each wrapper takes its plain version (``ref.py``) for CPU tensors, launches
its kernel for CUDA tensors, and counts its launches in ``.launches``.
Counts accumulate in int32 and are exact below 2^31 (the miner guards the
row count against that bound)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.nlist_intersect.ref import (
    nlist_intersect_fused_ref,
    nlist_intersect_masked_ref,
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "nlist_intersect_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _P, _P, _P],
    "nlist_intersect_es_launch": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _LL, _P, _P, _P],
}


def _check(a_pre, a_post, y_pre, y_post, y_cnt, a_cnt=None):
    B, La = a_pre.shape
    Ly = y_pre.shape[1]
    for name, t in (("a_pre", a_pre), ("a_post", a_post), ("a_cnt", a_cnt)):
        if t is not None:
            _cuda.check_tensor(t, name, torch.int32, (B, La))
    for name, t in (("y_pre", y_pre), ("y_post", y_post), ("y_cnt", y_cnt)):
        _cuda.check_tensor(t, name, torch.int32, (B, Ly))
    return B, La, Ly


def nlist_intersect_cuda(a_pre, a_post, y_pre, y_post, y_cnt):
    """B1: ``(merged (B, La) int32, supports (B,) int32)``. A rows must be
    pre-ascending (N-lists are), padding pre=INT32_MAX, post=-1, cnt=0."""
    if a_pre.device.type == "cpu":
        return nlist_intersect_fused_ref(a_pre, a_post, y_pre, y_post, y_cnt)
    B, La, Ly = _check(a_pre, a_post, y_pre, y_post, y_cnt)
    out = torch.empty((B, La), dtype=torch.int32, device=a_pre.device)
    sup = torch.empty(B, dtype=torch.int32, device=a_pre.device)
    lib = _cuda.library("nlist_intersect", _SIGNATURES)
    with torch.cuda.device(a_pre.device):
        rc = lib.nlist_intersect_launch(
            *map(_cuda.ptr, (a_pre, a_post, y_pre, y_post, y_cnt)),
            B, La, Ly, _cuda.ptr(out), _cuda.ptr(sup), _cuda.stream_of(a_pre),
        )
    _cuda.check_launch(rc, "nlist_intersect")
    nlist_intersect_cuda.launches += 1
    return out, sup


def nlist_intersect_es_cuda(a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, min_count, *,
                            la_block=512):
    """B2: B1 with tile-order early stop at ``min_count`` (see
    ``ref.nlist_intersect_masked_ref``, which it reproduces exactly)."""
    if a_pre.device.type == "cpu":
        return nlist_intersect_masked_ref(
            a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, min_count, la_block=la_block)
    B, La, Ly = _check(a_pre, a_post, y_pre, y_post, y_cnt, a_cnt)
    lab = max(1, min(int(la_block), La))
    out = torch.empty((B, La), dtype=torch.int32, device=a_pre.device)
    sup = torch.empty(B, dtype=torch.int32, device=a_pre.device)
    lib = _cuda.library("nlist_intersect", _SIGNATURES)
    with torch.cuda.device(a_pre.device):
        rc = lib.nlist_intersect_es_launch(
            *map(_cuda.ptr, (a_pre, a_post, a_cnt, y_pre, y_post, y_cnt)),
            B, La, Ly, lab, int(min_count), _cuda.ptr(out), _cuda.ptr(sup),
            _cuda.stream_of(a_pre),
        )
    _cuda.check_launch(rc, "nlist_intersect_es")
    nlist_intersect_es_cuda.launches += 1
    return out, sup


nlist_intersect_cuda.launches = 0
nlist_intersect_es_cuda.launches = 0
