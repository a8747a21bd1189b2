"""Roofline terms on one NVIDIA H100 SXM: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

Where the reference prices XLA's HLO against a TPU's rates, this module
prices a ``launch.cost.ProgramCost`` (the eager program's dispatched ops and
the hand-written kernels' own counts) against the H100's:

- ``t_compute``: the larger of the tensor-core FLOPs over the dense bf16
  peak and the scalar operations (elementwise ops, fp32 matmuls, the
  kernels' integer work) over the non-tensor fp32 rate;
- ``t_memory``: the bytes over the HBM3 rate;
- ``t_collective``: the bytes that leave a mesh position over one NVLink
  direction.

``collective_bytes`` keeps the reference's dict keys and its ring rule (an
all-reduce moves twice its payload, every other collective once), so that
records of the two packages read alike. ``model_flops`` is the reference's
formula: 6·N·D to train, 2·N·D otherwise, N the active parameters.
"""
from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989.4e12  # H100 SXM5 dense bf16 tensor-core FLOP/s (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3 bandwidth (NVIDIA H100 data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM5 non-tensor fp32 FLOP/s (NVIDIA H100 data sheet)
NVLINK_BYTES_PER_S = 450e9  # H100 SXM5 NVLink 4: 900 GB/s a GPU, 450 GB/s a direction (data sheet)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time one kernel's work could take on the card: its bytes at
    the HBM rate or its scalar operations at the non-tensor rate, whichever
    is longer. -> (ms, "bytes" | "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def collective_bytes(coll_payload: dict) -> dict:
    """Per-op payloads (the reference's op names) with the ring rule's wire
    bytes and the payloads' sum, under the reference's keys."""
    out = {k: coll_payload.get(k, 0) for k in COLLECTIVES}
    out["wire_bytes"] = sum(2 * v if k == "all-reduce" else v for k, v in out.items())
    out["payload_bytes"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    flops: float  # every counted operation: tensor-core FLOPs plus scalar ops
    hbm_bytes: float
    coll_bytes: float  # bytes that leave a mesh position
    mm_flops: float = 0.0  # the tensor-core share of ``flops``
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""

    def finalize(self) -> "Roofline":
        scalar = self.flops - self.mm_flops
        self.t_compute = max(self.mm_flops / PEAK_BF16_FLOPS, scalar / SCALAR_OPS_PER_S)
        self.t_memory = self.hbm_bytes / HBM_BYTES_PER_S
        self.t_collective = self.coll_bytes / NVLINK_BYTES_PER_S
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        return self

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


def analyze(pc) -> Roofline:
    """Roofline terms of a ``launch.cost.ProgramCost``."""
    return Roofline(flops=pc.flops, hbm_bytes=pc.hbm_bytes, coll_bytes=pc.wire_bytes,
                    mm_flops=pc.mm_flops).finalize()


def model_flops(cfg, shape_kind: str, seq: int, global_batch: int, n_chips: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params,
    per chip."""
    from repro_torch.models.common import n_params
    from repro_torch.models.registry import build_model

    n = n_params(build_model(cfg).param_specs())
    if cfg.n_experts:  # active params: replace E experts by top-k in FFN
        ffn = cfg.n_layers * 3 * cfg.d_model * cfg.d_ff
        n = n - cfg.n_experts * ffn + cfg.experts_per_token * ffn
    tokens = global_batch * (seq if shape_kind != "decode" else 1)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens / n_chips
