"""Training loop: step function + checkpointing + fault handling — the JAX
package's ``training/trainer.py``, on one torch device or, with ``rules``,
on a mesh (``training/step.py``: ZeRO-1 moments over the mesh's positions,
everything else on its first device).

Async checkpoints every ``ckpt_every`` steps and at the end,
restart-from-latest on (injected or real) failures, straggler flagging, and
metric logging. A fresh state draws its parameters from a
``torch.Generator`` seeded 42 on the device (the reference's
``PRNGKey(42)``); a restart restores the latest checkpoint onto the device
and fast-forwards the seeded batches, so the run continues as an
uninterrupted one would, bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.fault.failures import FailureInjector, StragglerMonitor, run_with_restarts
from repro_torch.training.step import TrainConfig, make_train_state, make_train_step, moment_shardings


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    max_restarts: int = 5
    straggler_threshold: float = 3.0


class Trainer:
    """``batches()`` returns a fresh, seeded iterator of batches (dicts of
    numpy arrays); each batch moves to ``device`` (CUDA unless the caller
    passes another; under ``rules``, the mesh's first device) before its
    step. A restart restores the moments onto the mesh's shardings."""

    def __init__(
        self,
        model,
        train_cfg: TrainConfig,
        loop_cfg: LoopConfig,
        batches: Callable[[], Iterator[dict]],
        rules=None,
        failure_injector: FailureInjector | None = None,
        device=None,
    ):
        self.model = model
        self.train_cfg = train_cfg
        self.loop = loop_cfg
        self.batches = batches
        self.rules = rules
        self.injector = failure_injector
        if rules is not None and device is not None:
            raise ValueError("a Trainer with rules runs on its mesh's first device: pass no device")
        self.device = rules.mesh.devices.flat[0] if rules is not None else resolve_device(device)
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir)
        self.monitor = StragglerMonitor(loop_cfg.straggler_threshold)
        self.history: list[dict] = []
        self._step_fn = make_train_step(model, train_cfg, rules)
        sh = moment_shardings(model, rules)
        self._restore_shardings = {"opt": {"m": sh, "v": sh}} if sh is not None else None

    def _fresh_state(self):
        return make_train_state(self.model, torch.Generator(device=self.device).manual_seed(42), self.train_cfg,
                                self.rules)

    def _run_once(self, start_step: int) -> int:
        if start_step > 0:
            state, _ = self.ckpt.restore(device=self.device, shardings=self._restore_shardings)
        else:
            state = self._fresh_state()
        gen = self.batches()
        # fast-forward the (seeded) generator so data order is reproducible
        for _ in range(start_step):
            next(gen)
        step = start_step
        while step < self.loop.total_steps:
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(gen).items()}
            if self.injector is not None:
                self.injector.maybe_fail(step)
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.monitor.record(step, dt):
                pass  # mitigation hook: pipeline.skip_slow() on a cluster
            if step % self.loop.log_every == 0 or step == self.loop.total_steps - 1:
                self.history.append({"step": step, "loss": loss, "dt": dt})
            step += 1
            if step % self.loop.ckpt_every == 0 or step == self.loop.total_steps:
                self.ckpt.save(step - 1, state, extra={"loss": loss}, block=False)
        self.ckpt.wait()
        return step

    def train(self) -> int:
        final = run_with_restarts(self._run_once, self.ckpt.latest_step, max_restarts=self.loop.max_restarts)
        self.ckpt.wait()
        return final
