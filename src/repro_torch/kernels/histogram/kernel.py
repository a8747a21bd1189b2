"""Wrapper of the hand-written CUDA histogram kernel B3
(``csrc/histogram.cu``), which replaces the TPU kernel
``repro/kernels/histogram/kernel.py:_hist_kernel``. CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the kernel, counted in
``histogram_cuda.launches``. Either route charges ``ops.histogram_cost``
to an active cost recorder."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.launch import cost

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"histogram_launch": [_P, _P, _LL, _I, _I, _P, _P]}


def _cost(rows, weights, *, n_bins):
    from repro_torch.kernels.histogram.ops import histogram_cost

    return histogram_cost(rows, weights, n_bins=n_bins)


@cost.charged(_cost)
def histogram_cuda(rows: torch.Tensor, weights: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """Weighted transaction-count histogram: rows (R, L) int32 (PAD = -1),
    weights (R,) int32 -> (n_bins,) int32."""
    if rows.device.type == "cpu":
        return histogram_ref(rows, weights, n_bins=n_bins)
    R, L = rows.shape
    _cuda.check_tensor(rows, "rows", torch.int32)
    _cuda.check_tensor(weights, "weights", torch.int32, (R,))
    out = torch.empty(n_bins, dtype=torch.int32, device=rows.device)
    lib = _cuda.library("histogram", _SIGNATURES)
    with torch.cuda.device(rows.device):
        rc = lib.histogram_launch(_cuda.ptr(rows), _cuda.ptr(weights), R, L, n_bins,
                                  _cuda.ptr(out), _cuda.stream_of(rows))
    _cuda.check_launch(rc, "histogram")
    _cuda.count_launch(histogram_cuda)
    return out


histogram_cuda.launches = 0
