"""Gradient compression with error feedback, as the slow-axis reduction
would deliver it (the JAX package's ``training/compress.py``):

  - int8 quantization with a per-tensor scale and stochastic rounding,
  - top-k magnitude sparsification.

The residual of this step's compression is added to the next step's
gradient, so the compression error does not accumulate. The rounding noise
comes from an explicit ``torch.Generator``, one draw a leaf in leaf order;
``int8_quantize`` takes the noise itself, so that any source of uniform
noise (the reference's too) can drive it.

``compressed_psum`` is the reference's ``shard_map`` building block for the
slow axis, single-controller: it takes the tensors of the shards along one
mesh axis (each on its position's device), quantizes each with its own
scale and noise, sums the int8 values as int32, and dequantizes the sum
with the largest scale, as the reference does (``pmax``). Where the shards'
scales differ that overweights the shards with smaller ones (shards [1.0,
0.5] and [0.01, 0.01] give [2.0, 1.504], not [1.01, 0.51]); the port keeps
the reference's formula. The result lands on the first shard's device.
"""
from __future__ import annotations

import torch


def int8_quantize(g: torch.Tensor, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, scale) of ``g`` rounded after adding ``noise``
    (uniform in [-0.5, 0.5): stochastic rounding, so E[deq] = g)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_compress(g: torch.Tensor, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32, device=g.device) - 0.5
    return int8_quantize(g, noise)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_compress(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top-``frac`` fraction by magnitude (dense mask form)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros((), dtype=g.dtype, device=g.device))


def compress_with_feedback(grads: dict, residuals: dict, generator: torch.Generator,
                           scheme: str = "int8", topk_frac: float = 0.05) -> tuple[dict, dict]:
    """grads + residuals -> (compressed-then-decompressed grads, new
    residuals), leaf by leaf in ``grads``' order."""
    out, new_res = {}, {}
    for k, g in grads.items():
        x = g.float() + residuals[k]
        if scheme == "int8":
            y = int8_decompress(*int8_compress(x, generator))
        elif scheme == "topk":
            y = topk_compress(x, topk_frac)
        else:
            raise ValueError(scheme)
        out[k] = y.to(g.dtype)
        new_res[k] = x - y
    return out, new_res


def compressed_psum(shards, noise) -> torch.Tensor:
    """int8-quantized sum of ``shards`` (one tensor per position along the
    axis), ``noise[i]`` the uniform [-0.5, 0.5) rounding noise of shard i."""
    dev = shards[0].device
    qsum, smax = None, None
    for x, n in zip(shards, noise, strict=True):
        q, scale = int8_quantize(x.float(), n.to(x.device))
        q, scale = q.to(dev, torch.int32), scale.to(dev)
        qsum = q if qsum is None else qsum + q
        smax = scale if smax is None else torch.maximum(smax, scale)
    # scales differ per shard: the reference dequantizes with their maximum
    return qsum.float() * smax


def init_residuals(tree: dict) -> dict:
    return {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for k, t in tree.items()}
