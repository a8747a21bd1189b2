"""SeamlessM4T-large-v2 (enc-dec, multimodal). [arXiv:2308.11596; hf]
24L (per stack) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Speech frontend is a STUB: input_specs() supplies precomputed frame
embeddings to the 24L encoder; the 24L decoder attends via cross-attention.
Decode shapes exercise the decoder KV cache + fixed encoder memory."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
)
