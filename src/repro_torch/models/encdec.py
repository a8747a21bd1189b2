"""Encoder-decoder model (SeamlessM4T-v2 backbone; audio frontend is a stub).

The JAX package's ``EncDecModel`` as an ``nn.Module``. Encoder: a
bidirectional transformer over precomputed frame embeddings. Decoder: causal
self-attention + cross-attention over the encoder memory. Cross-attention
K/V are computed once at prefill and cached; as in the reference, the cache
prefill returns holds them at the memory's length, not at the fresh cache's.
``loss`` runs each decoder layer under ``remat``, as the reference checkpoints
each; the encoder stores its activations, as there.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as ll
from repro_torch.models.common import ParamSpec, SpecModule, stack_specs
from repro_torch.models.transformer import clone_tree, decode_positions, layer_cache, positions


class EncDecModel(nn.Module):
    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.cfg = cfg
        specs = self._specs()
        self.embed = SpecModule(specs["embed"], device)
        self.frontend_proj = SpecModule(specs["frontend_proj"], device)
        self.register_parameter("enc_norm", nn.Parameter(
            torch.empty(specs["enc_norm"].shape, dtype=specs["enc_norm"].dtype, device=device)))
        self.encoder = nn.ModuleList(SpecModule(specs["enc_layer"], device) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(SpecModule(specs["dec_layer"], device) for _ in range(cfg.n_layers))

    def _specs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        return {
            "embed": ll.embed_specs(cfg),
            "frontend_proj": {
                "w": ParamSpec((d, d), ("embed", None)),
                "b": ParamSpec((d,), (None,), init="zeros"),
            },
            "enc_norm": ll.rmsnorm_spec(d),
            "enc_layer": {
                "ln1": ll.rmsnorm_spec(d),
                "attn": ll.attention_specs(cfg),
                "ln2": ll.rmsnorm_spec(d),
                "mlp": ll.mlp_specs(cfg),
            },
            "dec_layer": {
                "ln1": ll.rmsnorm_spec(d),
                "self_attn": ll.attention_specs(cfg),
                "lnx": ll.rmsnorm_spec(d),
                "cross_attn": ll.attention_specs(cfg),
                "ln2": ll.rmsnorm_spec(d),
                "mlp": ll.mlp_specs(cfg),
            },
        }

    def param_specs(self):
        s = self._specs()
        return {
            "embed": s["embed"],
            "frontend_proj": s["frontend_proj"],
            "enc_norm": s["enc_norm"],
            "encoder": stack_specs(s["enc_layer"], self.cfg.encoder_layers),
            "decoder": stack_specs(s["dec_layer"], self.cfg.n_layers),
        }

    def cache_specs(self, batch: int, seq: int, mem_len: int | None = None):
        cfg = self.cfg
        mem = mem_len if mem_len is not None else max(seq // 4, 1)
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        L = cfg.n_layers
        return {
            "kv": ll.cache_specs(cfg, batch, seq),
            "ck": ParamSpec((L, batch, mem, KV, hd), ("layers", "batch", "seq_kv", "kv_heads", None), init="zeros"),
            "cv": ParamSpec((L, batch, mem, KV, hd), ("layers", "batch", "seq_kv", "kv_heads", None), init="zeros"),
        }

    def forward(self, mode: str, *args):
        return getattr(self, mode)(*args)

    # ----------------------------------------------------------------- enc
    def encode(self, frames):
        cfg = self.cfg
        dt = ll.compute_dtype(cfg)
        x = ll.mm(frames.to(dt), self.frontend_proj["w"].to(dt)) + self.frontend_proj["b"].to(dt)
        B, S = x.shape[:2]
        pos = positions(B, S, x.device)
        for lp in self.encoder:
            h, _ = ll.attention(lp["attn"], ll.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, pos, causal=False)
            x = x + h
            x = x + ll.mlp(lp["mlp"], ll.rmsnorm(x, lp["ln2"], cfg.norm_eps))
        return ll.rmsnorm(x, self.enc_norm, cfg.norm_eps)

    def _cross_kv(self, lp, memory):
        k = ll.ein("bsd,dhk->bshk", memory, lp["cross_attn"]["wk"].to(memory.dtype))
        v = ll.ein("bsd,dhk->bshk", memory, lp["cross_attn"]["wv"].to(memory.dtype))
        return k, v

    # ----------------------------------------------------------------- dec
    def _dec_layer(self, lp, x, q_pos, mem_or_kv, kv_cache):
        cfg = self.cfg
        h, _ = ll.attention(lp["self_attn"], ll.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, q_pos, cache=kv_cache)
        x = x + h
        xn = ll.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        q = ll.ein("bsd,dhk->bshk", xn, lp["cross_attn"]["wq"].to(x.dtype))
        ck, cv = mem_or_kv if isinstance(mem_or_kv, tuple) else self._cross_kv(lp, mem_or_kv)
        mem_pos = positions(ck.shape[0], ck.shape[1], x.device)
        o = ll._attn_core(q, ck, cv, q_pos, mem_pos, causal=False)
        o = ll.ein("bshk,hkd->bsd", o, lp["cross_attn"]["wo"].to(x.dtype))
        x = x + o
        return x + ll.mlp(lp["mlp"], ll.rmsnorm(x, lp["ln2"], cfg.norm_eps)), (ck, cv)

    def decode_stack(self, x, q_pos, memory=None, cache=None, train: bool = False):
        if cache is None:
            for lp in self.decoder:
                if train:
                    x, _ = ll.remat(self._dec_layer, lp, x, q_pos, memory, None)
                else:
                    x, _ = self._dec_layer(lp, x, q_pos, memory, None)
            return x, None
        kv = clone_tree(cache["kv"])
        cks, cvs = [], []
        for i, lp in enumerate(self.decoder):
            mem = (cache["ck"][i], cache["cv"][i]) if memory is None else memory
            x, (ck, cv) = self._dec_layer(lp, x, q_pos, mem, layer_cache(kv, i))
            cks.append(ck)
            cvs.append(cv)
        return x, {"kv": kv, "ck": torch.stack(cks), "cv": torch.stack(cvs)}

    # ------------------------------------------------------------- task fns
    def loss(self, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        memory = self.encode(batch["frames"])
        x = ll.embed(self.embed, inputs, ll.compute_dtype(cfg))
        B, S = x.shape[:2]
        x, _ = self.decode_stack(x, positions(B, S, x.device), memory=memory, train=True)
        logits = ll.unembed(self.embed, x, cfg)
        mask = batch.get("loss_mask", torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        return ll.softmax_xent(logits, targets, mask)

    def prefill(self, batch, cache):
        cfg = self.cfg
        memory = self.encode(batch["frames"])
        x = ll.embed(self.embed, batch["tokens"], ll.compute_dtype(cfg))
        B, S = x.shape[:2]
        x, new_cache = self.decode_stack(x, positions(B, S, x.device), memory=memory, cache=cache)
        return ll.unembed(self.embed, x[:, -1:], cfg), new_cache

    def decode(self, batch, cache):
        cfg = self.cfg
        x = ll.embed(self.embed, batch["token"], ll.compute_dtype(cfg))
        q_pos = decode_positions(batch["pos"], x.shape[0], x.device)
        x, new_cache = self.decode_stack(x, q_pos, memory=None, cache=cache)
        return ll.unembed(self.embed, x, cfg), new_cache
