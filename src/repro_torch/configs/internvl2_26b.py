"""InternVL2-26B (InternViT + InternLM2 backbone). [arXiv:2404.16821; hf]
Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Vision frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (projected by a learned connector)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision",
    frontend_tokens=256,
)
