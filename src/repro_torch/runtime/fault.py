"""Fault-tolerant training runner: checkpoint/restart, failure injection,
straggler watchdog.

The PyTorch counterpart of the JAX package's ``src/repro/runtime/fault.py``:

  * checkpoint/restart — AsyncCheckpointer snapshots every ``ckpt_every``
    steps (and at the last step) without stalling the step loop; on any
    step failure the runner restores the latest checkpoint and replays (the
    data pipeline is stateless-deterministic, so replayed batches are
    identical).
  * stragglers — per-step wall time is tracked with an EMA; steps slower than
    ``straggler_factor`` x EMA increment a counter surfaced in the report,
    and an optional callback gets them.
  * node failure — after ``max_restarts`` consecutive failures the runner
    treats it as a topology change and calls ``on_topology_change`` if
    given (else raises): the hook rebuilds the mesh from the surviving ranks
    (``runtime/elastic.py``) and returns ``(state, shardings)``, the state
    restored and placed on the new mesh; later restores use those
    shardings. ``shardings`` (a tree of NamedShardings like the state)
    places every restore as DTensors.

A step that raises is caught and retried, so a caller that must not hide a
failure checks ``report.restarts``.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..checkpoint import AsyncCheckpointer, latest_step, restore


@dataclass
class FaultConfig:
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_grace_steps: int = 10
    on_straggler: Callable[[int, float, float], None] | None = None
    on_topology_change: Callable[[], Any] | None = None   # elastic hook


@dataclass
class RunReport:
    steps_done: int = 0
    restarts: int = 0
    straggler_events: int = 0
    losses: list = field(default_factory=list)


def run_training(
    step_fn: Callable[[Any, Any], tuple[Any, dict]],
    init_state: Any,
    batch_fn: Callable[[int], Any],
    num_steps: int,
    cfg: FaultConfig,
    *,
    state_like: Any | None = None,
    shardings: Any | None = None,
    fail_injector: Callable[[int], None] | None = None,
) -> tuple[Any, RunReport]:
    """Run ``num_steps`` with checkpoint/restart + straggler accounting.

    ``step_fn(state, batch) -> (state, metrics)``; metrics must contain
    'loss'. ``fail_injector(step)`` may raise to simulate node failures
    (tests do). A restart with no checkpoint yet starts again from
    ``init_state``, so ``step_fn`` must not update its state in place.
    """
    ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
    report = RunReport()
    state = init_state
    start_step = 0

    last = latest_step(cfg.ckpt_dir)
    if last is not None:
        state = restore(cfg.ckpt_dir, last, state_like or init_state, shardings)
        start_step = last
    ema = None
    step = start_step
    restarts = 0
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            if fail_injector is not None:
                fail_injector(step)
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            # straggler accounting
            if ema is None:
                ema = dt
            if step - start_step > cfg.straggler_grace_steps and dt > cfg.straggler_factor * ema:
                report.straggler_events += 1
                if cfg.on_straggler:
                    cfg.on_straggler(step, dt, ema)
            ema = 0.9 * ema + 0.1 * dt
            loss = metrics.get("loss")
            if loss is not None:
                report.losses.append(float(loss))
            step += 1
            report.steps_done += 1
            if step % cfg.ckpt_every == 0 or step == num_steps:
                ckpt.save_async(step, state)
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            report.restarts += 1
            if restarts > cfg.max_restarts:
                if cfg.on_topology_change is not None:
                    # elastic path: rebuild mesh/state and keep going
                    state, shardings = cfg.on_topology_change()
                    restarts = 0
                    continue
                raise
            ckpt.wait()
            last = latest_step(cfg.ckpt_dir)
            if last is not None:
                state = restore(cfg.ckpt_dir, last, state_like or init_state, shardings)
                step = last
            else:
                state = init_state
                step = 0
    ckpt.wait()
    return state, report
