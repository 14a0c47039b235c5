"""Config-gated profiling and step timing, the port's counterpart of the JAX
package's train/profiling.py:

  * ``train_params.profile: {start_step, num_steps}`` captures a
    torch.profiler trace (host and, where there is a card, CUDA activity)
    of those steps and writes it as a Chrome trace (viewable in Perfetto or
    chrome://tracing) into <run_dir>/profile. The trace holds the port's
    named spans (spans.py) beside the kernels: each step's
    ``xas.train.step`` and its phases (``xas.train.preprocess``,
    ``.gen_forward``, ``.gen_backward``, ``.disc_forward``,
    ``.disc_backward``, ``.allreduce``, ``.optimizer``, ``.metrics``), the
    modules and losses within them (``xas.model.*``, ``xas.loss.*``), the
    remat recompute (``xas.remat.recompute``) and each kernel op's forward
    and backward (``xas.op.*``) on the autograd engine's thread, and the
    trainer's wait on the loader (``xas.loader.wait``);
  * StepTimer keeps an online step-time EMA and writes it to TensorBoard
    (``meta/step_time_ms``, ``meta/images_per_sec``).
"""

from __future__ import annotations

import os
import time

import torch


class Profiler:
    def __init__(self, run_dir: str | None, start_step: int = -1,
                 num_steps: int = 0):
        self.dir = os.path.join(run_dir, "profile") if run_dir else None
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    @staticmethod
    def from_config(config: dict, run_dir: str | None) -> "Profiler":
        p = config.get("train_params", {}).get("profile", {}) or {}
        start = p.get("start_step", -1)
        if start >= 0 and run_dir is None:
            raise ValueError("train_params.profile needs a run directory")
        return Profiler(run_dir, start_step=start,
                        num_steps=p.get("num_steps", 0))

    def maybe_start(self, step: int) -> None:
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self._finish()
            print(f"profiler trace written to {self.dir}")

    def close(self) -> None:
        if self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_{self.start_step}_{self.stop_step}.json"))


class StepTimer:
    """Wall-clock step timing with warmup skip and EMA."""

    def __init__(self, ema: float = 0.9, skip: int = 3):
        self.ema = ema
        self.skip = skip
        self.count = 0
        self.avg_ms = None
        self._last = None

    def tick(self) -> float | None:
        """Call once per step; returns the last step's duration in ms."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt_ms = (now - self._last) * 1e3
        self._last = now
        self.count += 1
        if self.count <= self.skip:
            return dt_ms
        self.avg_ms = (
            dt_ms if self.avg_ms is None
            else self.ema * self.avg_ms + (1 - self.ema) * dt_ms
        )
        return dt_ms

    def log(self, tb_log, step: int, images_per_step: int) -> None:
        if tb_log is None or self.avg_ms is None:
            return
        tb_log.add_scalar("meta/step_time_ms", self.avg_ms, step)
        tb_log.add_scalar(
            "meta/images_per_sec", images_per_step / (self.avg_ms / 1e3), step
        )
