"""Zamba2-2.7B (Mamba2 backbone + shared attention). [arXiv:2411.15242; hf]
54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One *shared* (weight-tied) full-attention block applied every 6 layers
(the public model interleaves 2 shared blocks; we model the weight-tying
with a single shared block, noted in DESIGN.md). Mamba2 state + periodic
attention => subquadratic decode => long_500k applicable (attention KV is
sequence-sharded)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    subquadratic=True,
)
