"""Fault-tolerant training loop.

The JAX package's ``Trainer`` on tensors:

* periodic atomic checkpoints + automatic resume-from-latest (bitwise
  identical to an uninterrupted run);
* failure injection (``fail_at_step``) to exercise the crash/restart path;
* straggler detection: per-step wall-time EWMA + spike counter (a step's
  time is read after ``torch.cuda.synchronize`` on the card, as the JAX
  package reads it after ``block_until_ready``: otherwise it would time the
  launches and flag nothing);
* optional int8 gradient compression with error feedback.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.distributed.compression import compress_grads, init_residuals
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.utils import get_logger, tree

log = get_logger("train.trainer")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    keep_checkpoints: int = 3
    async_checkpoint: bool = False
    log_every: int = 10
    # fault tolerance / chaos
    fail_at_step: Optional[int] = None          # raise to simulate a crash
    # straggler watchdog
    straggler_factor: float = 3.0               # step > factor * EWMA => flag
    straggler_ewma: float = 0.9
    # gradient compression
    compress_grads: bool = False


@dataclass
class StragglerStats:
    ewma_s: float = 0.0
    flagged_steps: List[int] = field(default_factory=list)
    warmup: int = 2   # first steps include kernel builds — never representative

    def observe(self, step: int, dt: float, factor: float, decay: float) -> bool:
        if self.warmup > 0:
            self.warmup -= 1
            return False
        if self.ewma_s == 0.0:
            self.ewma_s = dt
            return False
        slow = dt > factor * self.ewma_s
        if slow:
            self.flagged_steps.append(step)
        else:
            self.ewma_s = decay * self.ewma_s + (1 - decay) * dt
        return slow


def _synchronize(params) -> None:
    """Wait for the device work behind ``params`` (a no-op on the CPU)."""
    devices = {t.device for t in tree.leaves(params) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Trainer:
    """Generic loop over (params, opt_state) with a step function.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``.
    When compression is on, the loop uses ``grad_step_fn(params, batch) ->
    (grads, metrics)`` + ``apply_fn(params, grads, opt_state)`` so the
    compressor sits on the gradient path.  ``batch`` arrays (numpy from the
    data pipelines) become tensors on the parameters' device."""

    def __init__(
        self,
        config: TrainerConfig,
        step_fn: Callable,
        params,
        opt_state,
        data: Iterator,
        grad_step_fn: Optional[Callable] = None,
        apply_fn: Optional[Callable] = None,
        step_hook: Optional[Callable[[int], None]] = None,
    ):
        self.cfg = config
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.grad_step_fn = grad_step_fn
        self.apply_fn = apply_fn
        self.step_hook = step_hook
        self.device = tree.leaves(params)[0].device
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, keep=config.keep_checkpoints,
            async_save=config.async_checkpoint)
        self.stragglers = StragglerStats()
        self.step = 0
        self.metrics_history: List[Dict] = []
        self._residuals = None

    # -- fault tolerance ---------------------------------------------------
    def try_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = self.ckpt.restore(
            {"params": self.params, "opt_state": self.opt_state}, step=latest)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.step = latest
        log.info("resumed from checkpoint step %d", latest)
        return True

    def _checkpoint(self) -> None:
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt_state": self.opt_state},
            metadata={"step": self.step},
        )

    # -- loop ------------------------------------------------------------------
    def run(self) -> Dict:
        cfg = self.cfg
        if cfg.compress_grads and self._residuals is None:
            self._residuals = init_residuals(self.params)
        while self.step < cfg.total_steps:
            batch = next(self.data)
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            t0 = time.perf_counter()
            if self.step_hook:
                self.step_hook(self.step)  # chaos/latency injection for tests
            if cfg.fail_at_step is not None and self.step == cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {self.step}")

            if cfg.compress_grads:
                grads, metrics = self.grad_step_fn(self.params, batch)
                grads, self._residuals = compress_grads(grads, self._residuals)
                self.params, self.opt_state = self.apply_fn(
                    self.params, grads, self.opt_state)
                del grads
            else:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
            _synchronize(self.params)
            dt = time.perf_counter() - t0
            self.step += 1

            slow = self.stragglers.observe(
                self.step, dt, cfg.straggler_factor, cfg.straggler_ewma)
            if slow:
                log.warning("straggler flagged at step %d (%.3fs vs EWMA %.3fs)",
                            self.step, dt, self.stragglers.ewma_s)
            self.metrics_history.append(
                {k: float(v) for k, v in metrics.items()} | {"step_time_s": dt})
            if self.step % cfg.log_every == 0:
                log.info("step %d: %s", self.step,
                         {k: round(float(v), 4) for k, v in metrics.items()})
            if self.step % cfg.checkpoint_every == 0:
                self._checkpoint()
        self.ckpt.wait()
        return {
            "final_step": self.step,
            "metrics": self.metrics_history,
            "stragglers": self.stragglers.flagged_steps,
        }
