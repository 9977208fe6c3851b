"""Preemption-aware training supervision and straggler logging (port of
``repro/distributed/fault_tolerance.py:35-101``, single host).

1. Preemption / crash safety: ``TrainSupervisor`` wraps the step loop --
   checkpoints every ``ckpt_every`` steps through the atomic
   ``CheckpointManager``, installs a SIGTERM handler that requests a final
   checkpoint before exit (a preemption notice), and on restart resumes
   from ``latest_step()`` including the data-iterator state.

2. Straggler logging: per-step host-clock time against an EWMA baseline;
   steps slower than ``straggler_factor`` x EWMA are recorded and the
   loop moves on.

3. Elastic re-mesh: ``maybe_resume(..., sharding_fn=)`` hands the
   function to ``CheckpointManager.restore``, which places every restored
   leaf on the mesh and by the spec it returns (a state saved on one mesh
   restarts on another), or on the device it returns.
"""
from __future__ import annotations

import signal
import time

__all__ = ["TrainSupervisor"]


class TrainSupervisor:
    def __init__(self, ckpt_manager, data_iter, *, ckpt_every: int = 100,
                 straggler_factor: float = 3.0):
        self.ckpt = ckpt_manager
        self.data = data_iter
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.ewma = None
        self.straggler_steps: list[int] = []
        self._preempted = False
        try:  # only the main thread may install a handler
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):
            pass

    def _on_sigterm(self, signum, frame):
        self._preempted = True

    # ---------------------------------------------------------------- resume
    def maybe_resume(self, example_state, *, sharding_fn=None):
        """Returns (state, start_step) -- restored if a checkpoint exists,
        its leaves placed by ``sharding_fn`` (``CheckpointManager.restore``)
        and the data iterator's state restored with it."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return example_state, 0
        state, meta = self.ckpt.restore(latest, example_state,
                                        sharding_fn=sharding_fn)
        if "data" in meta:
            self.data.restore(meta["data"])
        return state, latest

    # ------------------------------------------------------------------ loop
    def run(self, state, step_fn, *, start_step: int, num_steps: int,
            log_every: int = 50):
        """step_fn(state, batch) -> (state, metrics).  Returns (final
        state, the step reached).

        Checkpoints periodically and on preemption; records stragglers."""
        step = start_step
        while step < num_steps:
            t0 = time.monotonic()
            batch = self.data.next()
            state, metrics = step_fn(state, batch)
            dt = time.monotonic() - t0

            if self.ewma is None:
                self.ewma = dt
            elif dt > self.straggler_factor * self.ewma:
                self.straggler_steps.append(step)  # straggler: log, move on
            self.ewma = 0.9 * self.ewma + 0.1 * min(
                dt, self.straggler_factor * (self.ewma or dt))

            step += 1
            if step % self.ckpt_every == 0 or self._preempted:
                self.ckpt.save(step, state,
                               metadata={"data": self.data.state_dict()})
                if self._preempted:
                    break
        return state, step
