"""The train step: loss -> grads (autograd) -> optional compression -> AdamW.

The JAX package's ``training/step.py``. A train state is
``{"params", "opt": {"m", "v", "step"}, "rng"}`` plus ``"residuals"`` under
compression; ``params``, ``m``, ``v`` and ``residuals`` are ``state_dict``
mappings of the model (``models/convert.py`` maps them to the reference's
stacked trees), and ``rng`` is a ``torch.Generator``'s state (a uint8
tensor) where the reference keeps a PRNG key. Remat happens per layer
inside the model's ``loss``. The step runs under deterministic algorithms,
so that a rerun of the same steps gives the same bits on CUDA too, as XLA's
steps do (the embedding's and the MoE dispatch's backward would otherwise
accumulate with atomics).

With ``rules`` (a ``repro_torch.sharding.MeshRules``), as in the reference,
the step pins the moments to their ZeRO-1 shardings (``moment_shardings``:
the reference's ``moment_specs`` → ``param_shardings`` of the stacked
trees, mapped to the ``state_dict``'s keys by ``models/convert.py``), and
nothing else changes: the parameters, the batch and the gradients stay
whole on the mesh's first device, and the step's results equal the
one-device step's bit for bit. ``make_train_state`` takes ``rules`` and
ignores them, as the reference's does: the first step splits the moments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

from repro_torch.models.common import init_params, param_shardings
from repro_torch.models.convert import params_from_reference, shardings_from_reference
from repro_torch.training import compress as gc
from repro_torch.training.optim import OptConfig, adamw_update, init_opt_state, moment_specs


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    compression: str | None = None  # None | int8 | topk
    topk_frac: float = 0.05


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the enclosed ops. On CUDA they need a
    fixed cuBLAS workspace (``CUBLAS_WORKSPACE_CONFIG``), set here if unset;
    cuBLAS reads it when a process first uses it, so a process that runs
    other matmuls before it trains sets it at its start (``chip_smoke.py``
    does)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def moment_shardings(model, rules) -> dict | None:
    """The ZeRO-1 ``NamedSharding`` of each moment (``state_dict`` key ->
    sharding), or None without ``rules``."""
    if rules is None:
        return None
    return shardings_from_reference(model.cfg, param_shardings(moment_specs(model.param_specs(), rules), rules))


def make_train_state(model, generator: torch.Generator, train_cfg: TrainConfig, rules=None) -> dict:
    """A fresh state on ``generator``'s device: parameters drawn from it by
    the reference's init rules (in its leaf order), zero moments, and the
    state of a generator seeded 0 where the reference keeps ``PRNGKey(0)``.
    ``rules`` is taken and ignored, as by the reference."""
    tree = init_params(model.param_specs(), generator)
    params = {k: v.clone() for k, v in params_from_reference(model.cfg, tree).items()}  # own storage a leaf
    del tree
    state = {
        "params": params,
        "opt": init_opt_state(params),
        "rng": torch.Generator(device=generator.device).manual_seed(0).get_state(),
    }
    if train_cfg.compression:
        state["residuals"] = gc.init_residuals(params)
    return state


def make_train_step(model, train_cfg: TrainConfig, rules=None):
    """-> ``train_step(state, batch) -> (state, metrics)``, metrics ``loss``,
    ``lr`` and ``grad_norm`` (device scalars). ``model`` is the family's
    module (``build_model``); the step binds ``state["params"]`` to it
    without a copy and updates the state's tensors in place (p, g, m and v of
    a full-size model fill the card once, not twice). ``batch`` holds
    tensors on the state's device; under ``rules`` that is the mesh's first
    device."""
    mom_shardings = moment_shardings(model, rules)
    first = rules.mesh.devices.flat[0] if rules is not None else None
    bound = {}  # the params mapping the model holds, and its generator

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if bound.get("params") is not params:
            model.load_state_dict(params, strict=True, assign=True)  # shares each tensor's storage
            dev = next(iter(params.values())).device
            if first is not None and dev != first:
                raise ValueError(f"the parameters are on {dev}, not on the mesh's first device {first}")
            bound.update(params=params, gen=torch.Generator(device=dev) if train_cfg.compression else None)
        leaves = dict(model.named_parameters())
        with deterministic():
            loss = model.loss(batch)
            # a leaf the loss does not reach (the VLM connector without patches) gets
            # zeros, as jax.grad gives it
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                                         materialize_grads=True)))
        new_state = {"params": params, "rng": state["rng"]}
        if train_cfg.compression:
            gen = bound["gen"]
            gen.set_state(state["rng"].cpu())
            grads, new_state["residuals"] = gc.compress_with_feedback(
                grads, state["residuals"], gen, train_cfg.compression, train_cfg.topk_frac)
            new_state["rng"] = gen.get_state()
        _, new_state["opt"], metrics = adamw_update(train_cfg.opt, params, grads, state["opt"], mom_shardings)
        return new_state, dict(metrics, loss=loss.detach())

    return train_step
