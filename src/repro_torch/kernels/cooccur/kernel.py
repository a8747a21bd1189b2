"""Wrapper of the hand-written CUDA co-occurrence kernel B4
(``csrc/cooccur.cu``), which replaces the TPU kernel
``repro/kernels/cooccur/kernel.py:_cooc_kernel``. CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the kernel, counted in
``cooccur_cuda.launches``. Either route charges ``ops.cooccur_cost`` to an
active cost recorder."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.cooccur.ref import cooccur_ref
from repro_torch.launch import cost

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"cooccur_launch": [_P, _P, _LL, _I, _I, _P, _P]}


def _cost(rows, weights, *, n_items):
    from repro_torch.kernels.cooccur.ops import cooccur_cost

    return cooccur_cost(rows, weights, n_items=n_items)


@cost.charged(_cost)
def cooccur_cuda(rows: torch.Tensor, weights: torch.Tensor, *, n_items: int) -> torch.Tensor:
    """(K, K) weighted co-occurrence counts (full symmetric, diag = support)
    over rank rows (R, L) int32 (PAD = -1), weights (R,) int32."""
    if rows.device.type == "cpu":
        return cooccur_ref(rows, weights, n_items=n_items)
    R, L = rows.shape
    _cuda.check_tensor(rows, "rows", torch.int32)
    _cuda.check_tensor(weights, "weights", torch.int32, (R,))
    out = torch.empty((n_items, n_items), dtype=torch.int32, device=rows.device)
    lib = _cuda.library("cooccur", _SIGNATURES)
    with torch.cuda.device(rows.device):
        rc = lib.cooccur_launch(_cuda.ptr(rows), _cuda.ptr(weights), R, L, n_items,
                                _cuda.ptr(out), _cuda.stream_of(rows))
    _cuda.check_launch(rc, "cooccur")
    _cuda.count_launch(cooccur_cuda)
    return out


cooccur_cuda.launches = 0
