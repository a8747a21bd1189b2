"""Architecture registry: config -> model module + input specs.

The JAX package's ``models/registry.py``. ``build_model`` returns the
family's ``nn.Module`` with its parameters on the meta device (no memory);
``load_model`` gives it a state (``models/convert.py`` makes one from a
reference tree or an ``init_params`` tree). ``batch_specs`` /
``cache_specs_for`` build the ParamSpec trees of a shape cell's inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.layers import compute_dtype
from repro_torch.models.ssm_models import XLSTMModel, ZambaModel
from repro_torch.models.transformer import DecoderLM

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}


def build_model(cfg: ModelConfig, device="meta"):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, device)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, device)
    if cfg.family == "hybrid":
        return ZambaModel(cfg, device)
    if cfg.family == "encdec":
        return EncDecModel(cfg, device)
    raise ValueError(cfg.family)


def load_model(cfg: ModelConfig, state: dict, device) -> torch.nn.Module:
    """The family's module holding ``state`` (a ``state_dict`` mapping) on
    ``device``: tensors already there are taken as they are, not copied."""
    model = build_model(cfg)
    model.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True, assign=True)
    return model


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for a (arch, shape) cell."""
    s = SHAPES[shape_name]
    if s["kind"] == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch: no decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 0.5M-token dense KV pass skipped per assignment"
    return True, ""


def batch_specs(cfg: ModelConfig, shape_name: str, seq=None, batch=None) -> dict:
    """ParamSpec tree for the input batch of a shape cell."""
    s = SHAPES[shape_name]
    S = seq or s["seq"]
    B = batch or s["global_batch"]
    kind = s["kind"]
    i32 = torch.int32
    d = cfg.d_model
    dt = compute_dtype(cfg)

    def tok(shape):
        return ParamSpec(shape, ("batch", None), dtype=i32, init="zeros")

    if kind in ("train", "prefill"):
        extra = 1 if kind == "train" else 0
        out = {"tokens": tok((B, S + extra))}
        if cfg.family == "vlm":
            P = cfg.frontend_tokens
            out = {
                "tokens": tok((B, S - P + extra)),
                "patches": ParamSpec((B, P, d), ("batch", None, None), dtype=dt),
            }
        if cfg.family == "encdec":
            out["frames"] = ParamSpec((B, max(S // 4, 1), d), ("batch", None, None), dtype=dt)
        return out
    # decode: one token against a cache of length S
    return {
        "token": tok((B, 1)),
        "pos": ParamSpec((), (), dtype=i32, init="zeros"),
    }


def cache_specs_for(cfg: ModelConfig, shape_name: str, seq=None, batch=None):
    s = SHAPES[shape_name]
    if s["kind"] == "train":
        return None
    S = seq or s["seq"]
    B = batch or s["global_batch"]
    model = build_model(cfg)
    if cfg.family == "encdec":
        return model.cache_specs(B, S, mem_len=max(S // 4, 1))
    return model.cache_specs(B, S)


def step_fn(cfg: ModelConfig, shape_name: str):
    """The function a cell runs: loss (train) or prefill/decode (serve), as
    ``fn(state, batch[, cache])`` over a ``state_dict`` mapping."""
    model = build_model(cfg)
    mode = {"train": "loss", "prefill": "prefill", "decode": "decode"}[SHAPES[shape_name]["kind"]]

    def run(state, *args):
        return torch.func.functional_call(model, state, (mode, *args), strict=True)

    return run


def materialize_batch(cfg: ModelConfig, shape_name: str, seq: int, batch: int, key=None, device="cpu"):
    """Small real batch for smoke tests; the reference's draws
    (``np.random.default_rng(0)``), so both packages get the same batch."""
    specs = batch_specs(cfg, shape_name, seq=seq, batch=batch)
    rng = np.random.default_rng(0)
    out = {}
    for k, sp in specs.items():
        if sp.dtype == torch.int32 and k in ("tokens", "token"):
            out[k] = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=sp.shape).astype(np.int32)).to(device)
        elif k == "pos":
            out[k] = torch.tensor(seq - 1, dtype=torch.int32, device=device)
        else:
            x = torch.from_numpy(rng.normal(size=sp.shape).astype(np.float32))
            out[k] = x.to(device=device, dtype=compute_dtype(cfg))
    return out
