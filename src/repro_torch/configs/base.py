"""Model/run configuration system.

A copy of the JAX package's ``configs/base.py``: one frozen dataclass
describes every architecture; per-arch files under ``repro_torch/configs/``
instantiate it with the exact public hyperparameters. ``reduced()`` derives
the family-preserving tiny config used by the CPU tests; the full configs
are served on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: one shared attention block every k layers
    slstm_every: int = 0  # xlstm: an sLSTM block every k layers (rest mLSTM)
    # enc-dec
    encoder_layers: int = 0
    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str | None = None  # vision | audio
    frontend_tokens: int = 256
    # numerics / layout
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128
    # capability flags (drive shape-cell applicability)
    supports_decode: bool = True
    subquadratic: bool = False  # may run long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        layers = 4 if self.family == "hybrid" else 2 if not self.slstm_every else 4
        return dataclasses.replace(
            self,
            n_layers=layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            vocab_pad_multiple=16,
            n_experts=4 if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            slstm_every=2 if self.slstm_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=8 if self.frontend else 256,
            dtype="float32",
        )


ARCH_IDS = [
    "phi3_5_moe",
    "granite_moe",
    "qwen1_5_0_5b",
    "minitron_8b",
    "internlm2_20b",
    "tinyllama_1_1b",
    "xlstm_125m",
    "zamba2_2_7b",
    "internvl2_26b",
    "seamless_m4t_v2",
]

# CLI aliases (the assignment's hyphenated ids)
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "granite-moe-1b-a400m": "granite_moe",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "minitron-8b": "minitron_8b",
    "internlm2-20b": "internlm2_20b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
}


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
