"""Checkpoint policy, straggler watchdog and elastic remesh (the port of
``repro/runtime/fault_tolerance.py``).

* :class:`CheckpointPolicy`: periodic (optionally async) snapshots
  through ``checkpoint/checkpointer.py``, keeping the last k.
* :class:`StragglerWatchdog`: an EWMA of the per-step wall time; a step
  slower than ``threshold`` times the EWMA is a straggler.
* :func:`elastic_remesh`: the network and state are deterministic per
  global column id, so a run rebuilt on another mesh continues the same
  trajectory.
* :func:`train_with_recovery`: run, crash (simulated), restore the
  latest snapshot, continue.

The supervised multi-rank run (``runtime/multiprocess.py``,
``launch/launch_distributed.py``) uses the first two.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpointer as ckpt


@dataclasses.dataclass
class CheckpointPolicy:
    ckpt_dir: str
    every_steps: int = 100
    keep_last: int = 3
    async_save: bool = True
    # recorded in every manifest: the run's provenance (mesh shape, rank
    # count, grid, stdp), which the supervisor's reshard decision reads
    meta: Optional[dict] = None
    _pending: list = dataclasses.field(default_factory=list)

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.every_steps:
            return False
        os.makedirs(self.ckpt_dir, exist_ok=True)
        t = ckpt.save(self.ckpt_dir, step, tree,
                      blocking=not self.async_save, meta=self.meta)
        if t is not None:
            self._pending.append(t)
        self._gc()
        return True

    def _gc(self):
        try:
            names = os.listdir(self.ckpt_dir)
        except FileNotFoundError:
            return
        steps = sorted(int(d.split("_")[-1]) for d in names
                       if d.startswith("step_"))
        # keep_last <= 0 keeps nothing (steps[:-0] would keep everything)
        doomed = steps if self.keep_last <= 0 else steps[:-self.keep_last]
        for s in doomed:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def restore_latest(self, tree_like):
        return ckpt.restore(self.ckpt_dir, tree_like)


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time watchdog. ``observe`` returns True when the step is
    a straggler (and counts it); a straggler does not enter the EWMA."""
    threshold: float = 2.5
    alpha: float = 0.1
    ewma: Optional[float] = None
    stragglers: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, step_seconds: float) -> bool:
        if self.ewma is None:
            self.ewma = step_seconds
            return False
        is_straggler = step_seconds > self.threshold * self.ewma
        if is_straggler:
            self.stragglers += 1
            if self.on_straggler:
                self.on_straggler(step, step_seconds, self.ewma)
        else:
            self.ewma = (1 - self.alpha) * self.ewma \
                + self.alpha * step_seconds
        return is_straggler


def elastic_remesh(make_run: Callable, old_result, cfg, new_mesh):
    """Rebuild the distributed runner on ``new_mesh`` (``make_run(cfg,
    mesh) -> (run, spec)``); the trajectory continues exactly because
    everything regenerates per global column id."""
    run, spec = make_run(cfg, new_mesh)
    return run, spec


class SimulatedFailure(RuntimeError):
    """Raised by tests to kill a loop mid-step."""


def train_with_recovery(n_steps: int, step_fn: Callable, state,
                        policy: CheckpointPolicy,
                        fail_at: Optional[int] = None,
                        watchdog: Optional[StragglerWatchdog] = None):
    """Run ``step_fn(state, step) -> state`` for ``n_steps``, resuming
    from the policy's latest checkpoint when there is one (restored as
    numpy, so ``step_fn`` takes what it is given), with a simulated
    crash at ``fail_at``. Returns the final state."""
    step = 0
    try:
        state, step = policy.restore_latest(state)
        step += 1
    except (FileNotFoundError, ValueError):
        pass
    while step < n_steps:
        t0 = time.perf_counter()
        if fail_at is not None and step == fail_at:
            raise SimulatedFailure(f"injected failure at step {step}")
        state = step_fn(state, step)
        policy.maybe_save(step, state)
        if watchdog is not None:
            watchdog.observe(step, time.perf_counter() - t0)
        step += 1
    policy.wait()
    return state
