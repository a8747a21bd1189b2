"""The yardstick of the prep kernels: the H100's peaks, and the work of a
B3 (item histogram) and a B4 (co-occurrence) pass counted from their
inputs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM3 at 3.35 TB/s, and 67 T scalar (non-tensor fp32) operations a second.
A pass's bound is the larger of its bytes over the first and its
operations over the second. Each input byte is counted read once and each
output byte written once, whatever a kernel reads again; the operations
are what these inputs need (one update a valid slot for B3, one a pair of
valid slots in a row for B4), so the count is the same whatever
implements the kernel.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def histogram_work(n_rows: int, width: int, n_bins: int) -> tuple[int, int]:
    """(bytes, operations) of B3 over (n_rows, width) int32 rows with int32
    weights into ``n_bins`` int32 counts."""
    return n_rows * width * 4 + n_rows * 4 + n_bins * 4, n_rows * width


def cooccur_work(n_rows: int, width: int, n_valid: np.ndarray, k: int) -> tuple[int, int]:
    """(bytes, operations) of B4 over (n_rows, width) int32 rank rows, of
    which row i holds ``n_valid[i]`` frequent items, with int32 weights
    into a (k, k) int32 matrix: Σ over rows of n_valid squared pair
    updates."""
    n_valid = np.asarray(n_valid, np.int64)
    return n_rows * width * 4 + n_rows * 4 + k * k * 4, int((n_valid * n_valid).sum())
