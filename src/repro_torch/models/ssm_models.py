"""xLSTM (ssm family) and Zamba2 (hybrid family) model drivers.

xLSTM: groups of (slstm_every - 1) mLSTM blocks + 1 sLSTM block.
Zamba2: groups of ``attn_every`` Mamba2 blocks followed by one *shared*
(weight-tied) full-attention block: one module applied after every group,
with its own KV cache per group. The reference's (g, m, ...) and (g, ...)
stacked leaves are ``groups.<g>.mlstm.<m>`` / ``groups.<g>.slstm`` (and
``groups.<g>.mamba.<m>``) here; caches keep the reference's stacked layout.
``loss`` runs each group under ``remat`` (the reference checkpoints each
group) and keeps no recurrent state.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as ll
from repro_torch.models import ssm
from repro_torch.models.common import SpecModule, init_params, stack_specs
from repro_torch.models.transformer import clone_tree, decode_positions, layer_cache, positions


def _write_state(dst: dict, src: dict) -> None:
    for k, v in src.items():
        dst[k].copy_(v)


class XLSTMModel(nn.Module):
    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.cfg = cfg
        assert cfg.n_layers % cfg.slstm_every == 0
        self.n_groups = cfg.n_layers // cfg.slstm_every
        self.m_per_group = cfg.slstm_every - 1
        self.embed = SpecModule(ll.embed_specs(cfg), device)
        self.groups = nn.ModuleList(
            nn.ModuleDict({"mlstm": nn.ModuleList(SpecModule(ssm.mlstm_specs(cfg), device)
                                                  for _ in range(self.m_per_group)),
                           "slstm": SpecModule(ssm.slstm_specs(cfg), device)})
            for _ in range(self.n_groups))

    def param_specs(self):
        cfg = self.cfg
        group = {
            "mlstm": stack_specs(ssm.mlstm_specs(cfg), self.m_per_group),
            "slstm": ssm.slstm_specs(cfg),
        }
        return {"embed": ll.embed_specs(cfg), "groups": stack_specs(group, self.n_groups)}

    def cache_specs(self, batch: int, seq: int):
        g, m = self.n_groups, self.m_per_group
        return {
            "mlstm": ssm.mlstm_state_specs(self.cfg, batch, lead=(g, m), lead_axes=("layers", "layers")),
            "slstm": ssm.slstm_state_specs(self.cfg, batch, lead=(g,), lead_axes=("layers",)),
        }

    def forward(self, mode: str, *args):
        return getattr(self, mode)(*args)

    def _group(self, gp, x, gc: dict, single_step: bool = False, train: bool = False):
        """One group's mLSTM blocks, then its sLSTM, from the states in
        ``gc`` (views of the stacked cache), written back unless ``train``."""
        for j, lp in enumerate(gp["mlstm"]):
            lc = layer_cache(gc["mlstm"], j)
            x, st = ssm.mlstm(lp, x, self.cfg, state=lc, single_step=single_step)
            if not train:
                _write_state(lc, st)
        x, st = ssm.slstm(gp["slstm"], x, self.cfg, state=gc["slstm"], single_step=single_step, train=train)
        if not train:
            _write_state(gc["slstm"], st)
        return x

    def backbone(self, x, cache=None, single_step: bool = False, train: bool = False):
        if cache is None:
            # fresh states from the specs (m-stabilizers at -1e30, sLSTM n at 1)
            cache = init_params(self.cache_specs(x.shape[0], 0), device=x.device)
        else:
            cache = clone_tree(cache)
        for g, gp in enumerate(self.groups):
            gc = {"mlstm": layer_cache(cache["mlstm"], g), "slstm": layer_cache(cache["slstm"], g)}
            if train:
                x = ll.remat(self._group, gp, x, gc, single_step, True)
            else:
                x = self._group(gp, x, gc, single_step)
        return x, cache

    def loss(self, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        x = ll.embed(self.embed, inputs, ll.compute_dtype(cfg))
        x, _ = self.backbone(x, train=True)
        logits = ll.unembed(self.embed, x, cfg)
        mask = batch.get("loss_mask", torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        return ll.softmax_xent(logits, targets, mask)

    def prefill(self, batch, cache):
        x = ll.embed(self.embed, batch["tokens"], ll.compute_dtype(self.cfg))
        x, new_cache = self.backbone(x, cache=cache)
        return ll.unembed(self.embed, x[:, -1:], self.cfg), new_cache

    def decode(self, batch, cache):
        x = ll.embed(self.embed, batch["token"], ll.compute_dtype(self.cfg))
        x, new_cache = self.backbone(x, cache=cache, single_step=True)
        return ll.unembed(self.embed, x, self.cfg), new_cache


class ZambaModel(nn.Module):
    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.cfg = cfg
        assert cfg.n_layers % cfg.attn_every == 0
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.m_per_group = cfg.attn_every
        specs = self.param_specs()
        self.embed = SpecModule(specs["embed"], device)
        self.groups = nn.ModuleList(
            nn.ModuleDict({"mamba": nn.ModuleList(SpecModule(ssm.mamba2_specs(cfg), device)
                                                  for _ in range(self.m_per_group))})
            for _ in range(self.n_groups))
        self.shared_attn = SpecModule(specs["shared_attn"], device)

    def param_specs(self):
        cfg = self.cfg
        group = {"mamba": stack_specs(ssm.mamba2_specs(cfg), self.m_per_group)}
        shared = {
            "ln": ll.rmsnorm_spec(cfg.d_model),
            "attn": ll.attention_specs(cfg),
            "ln2": ll.rmsnorm_spec(cfg.d_model),
            "mlp": ll.mlp_specs(cfg),
        }
        return {
            "embed": ll.embed_specs(cfg),
            "groups": stack_specs(group, self.n_groups),
            "shared_attn": shared,
        }

    def cache_specs(self, batch: int, seq: int):
        g, m = self.n_groups, self.m_per_group
        return {
            "mamba": ssm.mamba2_state_specs(self.cfg, batch, lead=(g, m), lead_axes=("layers", "layers")),
            "kv": ll.cache_specs(self.cfg, batch, seq, layers=g),
        }

    def forward(self, mode: str, *args):
        return getattr(self, mode)(*args)

    def _group(self, gp, x, q_pos, mamba: dict, kv, single_step: bool = False, train: bool = False):
        """One group's Mamba2 blocks from the states in ``mamba`` (views of
        the stacked cache, written back unless ``train``), then the shared
        (weight-tied) attention block with the group's own KV cache."""
        cfg, shared = self.cfg, self.shared_attn
        for j, lp in enumerate(gp["mamba"]):
            lc = layer_cache(mamba, j)
            y, st = ssm.mamba2(lp, x, cfg, state=lc, single_step=single_step)
            x = x + y
            if not train:
                _write_state(lc, st)
        h, _ = ll.attention(shared["attn"], ll.rmsnorm(x, shared["ln"], cfg.norm_eps), cfg, q_pos, cache=kv)
        x = x + h
        return x + ll.mlp(shared["mlp"], ll.rmsnorm(x, shared["ln2"], cfg.norm_eps))

    def backbone(self, x, q_pos, cache=None, single_step: bool = False, train: bool = False):
        cfg = self.cfg
        if cache is None:
            # fresh Mamba2 states, no KV cache (and none returned)
            states = {"mamba": init_params(ssm.mamba2_state_specs(
                cfg, x.shape[0], lead=(self.n_groups, self.m_per_group), lead_axes=("layers", "layers")),
                device=x.device), "kv": None}
        else:
            states = clone_tree(cache)
        for g, gp in enumerate(self.groups):
            mamba = layer_cache(states["mamba"], g)
            if train:
                x = ll.remat(self._group, gp, x, q_pos, mamba, None, single_step, True)
            else:
                kv = layer_cache(states["kv"], g) if states["kv"] is not None else None
                x = self._group(gp, x, q_pos, mamba, kv, single_step)
        return x, (states if cache is not None else None)

    def loss(self, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        x = ll.embed(self.embed, inputs, ll.compute_dtype(cfg))
        B, S = x.shape[:2]
        x, _ = self.backbone(x, positions(B, S, x.device), train=True)
        logits = ll.unembed(self.embed, x, cfg)
        mask = batch.get("loss_mask", torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        return ll.softmax_xent(logits, targets, mask)

    def prefill(self, batch, cache):
        cfg = self.cfg
        x = ll.embed(self.embed, batch["tokens"], ll.compute_dtype(cfg))
        B, S = x.shape[:2]
        x, new_cache = self.backbone(x, positions(B, S, x.device), cache=cache)
        return ll.unembed(self.embed, x[:, -1:], cfg), new_cache

    def decode(self, batch, cache):
        cfg = self.cfg
        x = ll.embed(self.embed, batch["token"], ll.compute_dtype(cfg))
        q_pos = decode_positions(batch["pos"], x.shape[0], x.device)
        x, new_cache = self.backbone(x, q_pos, cache=cache, single_step=True)
        return ll.unembed(self.embed, x, cfg), new_cache
