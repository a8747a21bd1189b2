"""Decoder-only LM covering the dense / moe / vlm families.

The JAX package's ``DecoderLM`` as an ``nn.Module``: the reference's stacked
(L, ...) layer parameters are one ``SpecModule`` a layer in ``layers``, so
``layers.3.attn.wq`` is ``params["layers"]["attn"]["wq"][3]``. The VLM
variant prepends connector-projected patch embeddings (frontend stub).
``loss`` runs the backbone with ``train=True``: each layer under
``torch.utils.checkpoint`` (its activations recomputed in the backward, as
the reference's per-layer ``jax.checkpoint``); prefill and decode store
nothing for a backward.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as ll
from repro_torch.models.common import ParamSpec, SpecModule, stack_specs
from repro_torch.models.moe import moe_ffn, moe_specs


def clone_tree(tree):
    """A copy of a cache tree (dicts of tensors); the models write the copy,
    so a cache handed to ``prefill``/``decode`` is never changed."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def layer_cache(cache: dict, *idx) -> dict:
    """The views of one layer's (or group member's) slots of a stacked cache."""
    return {k: (layer_cache(v, *idx) if isinstance(v, dict) else v[idx]) for k, v in cache.items()}


def positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def decode_positions(pos, B: int, device) -> torch.Tensor:
    """The (B, 1) query positions of a decode step at scalar ``pos``."""
    return torch.as_tensor(pos, device=device).to(torch.int32).reshape(1, 1).expand(B, 1)


class DecoderLM(nn.Module):
    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.cfg = cfg
        self.embed = SpecModule(ll.embed_specs(cfg), device)
        self.layers = nn.ModuleList(SpecModule(self.layer_specs(), device) for _ in range(cfg.n_layers))
        if cfg.frontend == "vision":
            self.connector = SpecModule(self.param_specs()["connector"], device)

    # ---------------------------------------------------------------- specs
    def layer_specs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        p = {
            "ln1": ll.rmsnorm_spec(d),
            "attn": ll.attention_specs(cfg),
            "ln2": ll.rmsnorm_spec(d),
        }
        if cfg.n_experts:
            p["moe"] = moe_specs(cfg)
        else:
            p["mlp"] = ll.mlp_specs(cfg)
        return p

    def param_specs(self) -> dict:
        cfg = self.cfg
        p = {
            "embed": ll.embed_specs(cfg),
            "layers": stack_specs(self.layer_specs(), cfg.n_layers),
        }
        if cfg.frontend == "vision":
            p["connector"] = {
                "w": ParamSpec((cfg.d_model, cfg.d_model), ("embed", None)),
                "b": ParamSpec((cfg.d_model,), (None,), init="zeros"),
            }
        return p

    def cache_specs(self, batch: int, seq: int) -> dict:
        return {"kv": ll.cache_specs(self.cfg, batch, seq)}

    # -------------------------------------------------------------- forward
    def forward(self, mode: str, *args):
        """``mode`` names the task function (``loss``, ``prefill``,
        ``decode``), so that ``torch.func.functional_call`` can run each."""
        return getattr(self, mode)(*args)

    def _layer(self, p, x, q_pos, cache):
        cfg = self.cfg
        h, _ = ll.attention(p["attn"], ll.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, q_pos, cache=cache)
        x = x + h
        hn = ll.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.n_experts:
            h, aux = moe_ffn(p["moe"], hn, cfg)
        else:
            h, aux = ll.mlp(p["mlp"], hn), torch.zeros((), device=x.device)
        return x + h, aux

    def backbone(self, x, q_pos, cache=None, train: bool = False):
        kv = clone_tree(cache["kv"]) if cache is not None else None
        aux = torch.zeros((), device=x.device)
        for i, lp in enumerate(self.layers):
            if train:
                x, a = ll.remat(self._layer, lp, x, q_pos, None)
            else:
                x, a = self._layer(lp, x, q_pos, layer_cache(kv, i) if kv is not None else None)
            aux = aux + a
        return x, aux, ({"kv": kv} if kv is not None else None)

    def logits(self, x):
        return ll.unembed(self.embed, x, self.cfg)

    def embed_inputs(self, tokens, patches=None):
        dt = ll.compute_dtype(self.cfg)
        x = ll.embed(self.embed, tokens, dt)
        if patches is not None:
            px = ll.mm(patches.to(dt), self.connector["w"].to(dt)) + self.connector["b"].to(dt)
            x = torch.cat([px, x], dim=1)
        return x

    # ------------------------------------------------------------ task fns
    def loss(self, batch):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        patches = batch.get("patches")
        x = self.embed_inputs(inputs, patches)
        B, S = x.shape[0], x.shape[1]
        x, aux, _ = self.backbone(x, positions(B, S, x.device), train=True)
        if patches is not None:
            x = x[:, patches.shape[1]:]
        logits = self.logits(x)
        mask = batch.get("loss_mask", torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        return ll.softmax_xent(logits, targets, mask) + 0.01 * aux

    def prefill(self, batch, cache):
        x = self.embed_inputs(batch["tokens"], batch.get("patches"))
        B, S = x.shape[0], x.shape[1]
        x, _, new_cache = self.backbone(x, positions(B, S, x.device), cache=cache)
        return self.logits(x[:, -1:]), new_cache

    def decode(self, batch, cache):
        x = self.embed_inputs(batch["token"])
        x, _, new_cache = self.backbone(x, decode_positions(batch["pos"], x.shape[0], x.device), cache=cache)
        return self.logits(x), new_cache
