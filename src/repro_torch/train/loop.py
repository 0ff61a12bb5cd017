"""Fault-tolerant training loop (counterpart of ``repro.train.loop``).

  * auto-resume from the latest committed checkpoint (crash == restart);
  * async checkpoint saves with retention;
  * simulated preemption (raise at step k): a restart loses at most
    ``save_every`` steps and replays the data stream by step;
  * straggler watchdog: a per-step wall-clock budget, whose breaches
    save a checkpoint at once and are counted;
  * the optional GQL spectral monitor (``train.monitor``).

``step_fn`` may update the parameters and optimizer state in place (the
port's ``build_train_step`` does); the saver snapshots them to the host
before the next step runs.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Optional

from ..checkpoint import io as ckpt_io


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    save_every: int = 25
    keep_checkpoints: int = 3
    log_every: int = 10
    step_time_budget_s: Optional[float] = None   # straggler watchdog
    monitor_every: int = 0                        # 0 = off


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    resumed_from: Optional[int]
    straggler_events: int
    monitor_log: list


def train(
    *,
    loop_cfg: LoopConfig,
    ckpt_dir: str | Path,
    init_state: Callable[[], tuple],     # () -> (params, opt_state)
    step_fn: Callable,                   # (params, opt, batch) -> (p, o, m)
    batch_fn: Callable[[int], Any],      # step -> batch
    monitor_fn: Optional[Callable] = None,
    fail_at_step: Optional[int] = None,  # test hook: simulate preemption
) -> LoopResult:
    ckpt_dir = Path(ckpt_dir)
    saver = ckpt_io.AsyncSaver()

    params, opt_state = init_state()
    start = 0
    resumed_from = None
    latest = ckpt_io.latest_step(ckpt_dir)
    if latest is not None:
        params, opt_state = ckpt_io.restore(ckpt_dir, latest,
                                            (params, opt_state))
        start = latest
        resumed_from = latest

    losses = []
    monitor_log = []
    stragglers = 0
    for step in range(start, loop_cfg.total_steps):
        if fail_at_step is not None and step == fail_at_step:
            saver.wait()
            raise RuntimeError(f"simulated preemption at step {step}")
        t0 = time.time()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0

        if loop_cfg.step_time_budget_s and dt > loop_cfg.step_time_budget_s:
            stragglers += 1
            # persist progress at once, so a slice swap or restart loses
            # nothing
            saver.save(ckpt_dir, step + 1, (params, opt_state),
                       extra={"straggler": True, "step_time": dt})

        if loop_cfg.monitor_every and monitor_fn is not None \
                and (step + 1) % loop_cfg.monitor_every == 0:
            monitor_log.append((step + 1, monitor_fn(params, batch)))

        if (step + 1) % loop_cfg.save_every == 0 \
                or step + 1 == loop_cfg.total_steps:
            saver.save(ckpt_dir, step + 1, (params, opt_state))
            ckpt_io.retain(ckpt_dir, keep=loop_cfg.keep_checkpoints)

    saver.wait()
    ckpt_io.retain(ckpt_dir, keep=loop_cfg.keep_checkpoints)
    return LoopResult(final_step=loop_cfg.total_steps, losses=losses,
                      resumed_from=resumed_from,
                      straggler_events=stragglers,
                      monitor_log=monitor_log)
