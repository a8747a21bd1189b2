"""Granite-3.0-1B-A400M: 1B total / 400M active.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H
(GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
)
