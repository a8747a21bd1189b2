"""Wrapper of the hand-written CUDA co-occurrence kernel B4
(``csrc/cooccur.cu``), which replaces the TPU kernel
``repro/kernels/cooccur/kernel.py:_cooc_kernel``. CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the kernel, counted in
``cooccur_cuda.launches``. Either route charges ``ops.cooccur_cost`` to an
active cost recorder.

For K > 128 one launch is a bucketing pass (each rank read once, grouped
by 128-item band into the scratch) and a persistent wgmma product over the
output's upper-triangular 128 x 128 tiles; the wrapper allocates their
scratch with ``torch.empty``, at the size the library's
``cooccur_scratch_bytes`` gives. K <= 128 (one band) runs one single-tile
kernel, which needs no scratch."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.cooccur.ref import cooccur_ref
from repro_torch.launch import cost

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH = [_P, _P, _LL, _I, _I, _P, _P, _LL, _I, _P]
_SIGNATURES = {"cooccur_launch": _LAUNCH, "cooccur_bucket_launch": _LAUNCH,
               "cooccur_scratch_bytes": [_LL, _I, _I, _I], "cooccur_smem_bytes": [_I, _I, _I]}

BAND = 128  # items a band: an output tile's side, and rows a row tile
MIN_ROW_TILES = 4  # row tiles a product block takes at the least, on average


def product_blocks(R: int, K: int, sms: int) -> int:
    """Persistent blocks of the product kernel: one a SM, fewer when the
    upper-triangular tiles times the row tiles would give a block fewer
    than ``MIN_ROW_TILES`` row tiles (each piece ends in an epilogue of up
    to 2 x 128 x 128 atomics)."""
    nb, n_rt = -(-K // BAND), -(-R // BAND)
    work = nb * (nb + 1) // 2 * n_rt
    return max(1, min(sms, -(-work // MIN_ROW_TILES)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cost(rows, weights, *, n_items):
    from repro_torch.kernels.cooccur.ops import cooccur_cost

    return cooccur_cost(rows, weights, n_items=n_items)


def _library():
    lib = _cuda.library("cooccur", _SIGNATURES)
    lib.cooccur_scratch_bytes.restype = ctypes.c_longlong
    lib.cooccur_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch(fn: str, rows: torch.Tensor, weights: torch.Tensor, n_items: int):
    R, L = rows.shape
    _cuda.check_tensor(rows, "rows", torch.int32)
    _cuda.check_tensor(weights, "weights", torch.int32, (R,))
    out = torch.empty((n_items, n_items), dtype=torch.int32, device=rows.device)
    blocks = product_blocks(R, n_items, _sms(rows.device.index or 0))
    lib = _library()
    nbytes = lib.cooccur_scratch_bytes(R, L, n_items, blocks)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=rows.device)
    with torch.cuda.device(rows.device):
        rc = getattr(lib, fn)(_cuda.ptr(rows), _cuda.ptr(weights), R, L, n_items, _cuda.ptr(out),
                                     _cuda.ptr(scratch), nbytes, blocks, _cuda.stream_of(rows))
    _cuda.check_launch(rc, "cooccur")
    return out, scratch


@cost.charged(_cost)
def cooccur_cuda(rows: torch.Tensor, weights: torch.Tensor, *, n_items: int) -> torch.Tensor:
    """(K, K) weighted co-occurrence counts (full symmetric, diag = support)
    over rank rows (R, L) int32 (PAD = -1), weights (R,) int32."""
    if rows.device.type == "cpu":
        return cooccur_ref(rows, weights, n_items=n_items)
    out, _ = _launch("cooccur_launch", rows, weights, n_items)
    _cuda.count_launch(cooccur_cuda)
    return out


cooccur_cuda.launches = 0


def cooccur_bucket_pass(rows: torch.Tensor, weights: torch.Tensor, *, n_items: int) -> torch.Tensor:
    """The kernel's bucketing pass alone on CUDA rows (it zeroes C and
    fills the scratch; no product), to time it apart. Not a main-path
    launch: it is not counted. -> the scratch."""
    if n_items <= BAND:
        raise ValueError("K <= 128 runs the single-band kernel, which has no bucketing pass")
    return _launch("cooccur_bucket_launch", rows, weights, n_items)[1]
