"""Serving engine: batched prefill + greedy decode with a static KV cache.

The JAX package's ``serving/engine.py`` on a torch device: requests are
packed into one fixed-size batch (left-padded with token 0, which the
attention sees: there is no pad mask, as in the reference), each wave gets a
fresh cache of ``max_seq`` slots, and decoding stops at ``max_new`` tokens
or when the position reaches ``max_seq - 1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import init_params
from repro_torch.models.layers import compute_dtype
from repro_torch.models.registry import cache_specs_for, load_model


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (plen,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)


class Engine:
    """``params`` is the model's ``state_dict`` mapping (``models/convert.py``);
    its tensors move to ``device`` (CUDA unless the caller passes another),
    and tensors already there are used in place."""

    def __init__(self, cfg, params: dict, batch_size: int, max_seq: int, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = load_model(cfg, params, self.device)
        self.B = batch_size
        self.S = max_seq

    def _fresh_cache(self):
        specs = cache_specs_for(self.cfg, "decode_32k", seq=self.S, batch=self.B)
        return init_params(specs, device=self.device)

    @torch.inference_mode()
    def generate(self, requests: list[Request], greedy: bool = True) -> list[Request]:
        """Serve a wave of requests (padded to the static batch)."""
        assert len(requests) <= self.B
        dev = self.device
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.B, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if self.cfg.family == "encdec":
            batch["frames"] = torch.zeros((self.B, max(plen // 4, 1), self.cfg.d_model),
                                          dtype=compute_dtype(self.cfg), device=dev)
        cache = self._fresh_cache()
        logits, cache = self.model.prefill(batch, cache)
        pos = plen
        max_new = max(r.max_new for r in requests)
        for _ in range(max_new):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            host = nxt.cpu().tolist()
            for i, r in enumerate(requests):
                if len(r.out) < r.max_new:
                    r.out.append(host[i])
            if pos >= self.S - 1:
                break
            logits, cache = self.model.decode({"token": nxt[:, None], "pos": pos}, cache)
            pos += 1
        return requests
