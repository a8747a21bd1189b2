"""xLSTM-125M (sLSTM + mLSTM blocks). [arXiv:2405.04517; unverified] 12L
d_model=768 4H d_ff=0 (projection factor inside blocks) vocab=50304.
One sLSTM block every 4 layers, rest mLSTM (paper's 7:1-ish mix at small
scale). Recurrent state => O(1)/token decode => long_500k applicable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    supports_decode=True,
    subquadratic=True,
)
