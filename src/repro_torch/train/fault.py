"""Fault tolerance + straggler mitigation for the training loop: the
port's copy of ``repro.train.fault`` (NumPy only, as the reference's).

Mechanisms (all exercised by tests on CPU; at scale they compose with the
multi-host runtime):

  * NaN/Inf sentinel: every step's loss/grad-norm is checked; a bad step
    triggers rollback to the last checkpoint and a data-skip past the bad
    batch (deterministic resume — the data pipeline is step-indexed).
  * Crash restart: checkpoints are atomic (checkpoint.py); the loop always
    resumes from latest_step().
  * Preemption: a SIGTERM-style flag forces an immediate checkpoint.
  * Straggler mitigation: a pluggable StepTimer tracks a rolling step-time
    distribution; steps exceeding mean + k*std raise a straggler event —
    at scale the runner responds by excluding/replacing the slow host and
    re-forming the mesh; here the policy logic itself is what is under
    test.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class FaultConfig:
    checkpoint_every: int = 50
    max_rollbacks: int = 3
    straggler_window: int = 32
    straggler_sigma: float = 4.0


class StepTimer:
    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.times: deque[float] = deque(maxlen=cfg.straggler_window)
        self.events: list[dict] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        if len(self.times) >= 8:
            mean = float(np.mean(self.times))
            std = float(np.std(self.times)) + 1e-9
            if seconds > mean + self.cfg.straggler_sigma * std:
                self.events.append({"step": step, "seconds": seconds,
                                    "mean": mean, "std": std})
                self.times.append(seconds)
                return True
        self.times.append(seconds)
        return False


def is_bad(metrics: dict) -> bool:
    for k in ("loss", "grad_norm"):
        v = metrics.get(k)
        if v is not None and not np.isfinite(float(v)):
            return True
    return False


class Preemption:
    """Cooperative preemption flag (SIGTERM handler sets it at scale)."""

    def __init__(self):
        self.requested = False

    def request(self):
        self.requested = True


@dataclasses.dataclass
class RunReport:
    steps_run: int = 0
    rollbacks: int = 0
    checkpoints: int = 0
    stragglers: int = 0
    final_step: int = 0
    # per accepted step: step, loss, grad_norm, lr, seconds (the port's)
    history: list[dict] = dataclasses.field(default_factory=list,
                                            repr=False)
