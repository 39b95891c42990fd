"""Run metrics and timing (port of ``dlp_admm_tpu/utils/metrics.py``).

:class:`RunMetrics` keeps the per-step history and the aggregate report of
one MPC run, with the same keys as the JAX version. The native trace stream
(``trace_path``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("dlp_admm_torch")


@dataclass
class RunMetrics:
    """Per-step history + aggregate report of one MPC run."""

    step_times: List[float] = field(default_factory=list)
    iter_history: List[int] = field(default_factory=list)     # `iter_his`
    extras: Dict[str, list] = field(default_factory=dict)
    trace_path: Optional[str] = None

    def __post_init__(self):
        if self.trace_path is not None:
            raise NotImplementedError(
                "the native trace stream is not ported yet (ROADMAP.md "
                "queue 1, item 'mpc/driver.py and the utilities')")

    @contextlib.contextmanager
    def step_timer(self):
        t = time.perf_counter()
        yield
        self.step_times.append(time.perf_counter() - t)

    def log_step(self, step: int, iterations: int, **kv):
        """Record + log one MPC step (the reference's per-step print,
        ``casadi/main.py:193-196``)."""
        self.iter_history.append(int(iterations))
        for k, v in kv.items():
            self.extras.setdefault(k, []).append(v)
        logger.info("t_step: %d, iter: %d, %s", step, iterations,
                    ", ".join(f"{k}: {v}" for k, v in kv.items()))

    @property
    def total_iterations(self) -> int:                        # `sum_iter_num`
        return sum(self.iter_history)

    def summary(self) -> dict:
        """Aggregate report (the MATLAB end-of-run print)."""
        n = max(len(self.step_times), 1)
        out = dict(
            steps=len(self.iter_history),
            total_iterations=self.total_iterations,
            mean_iterations=(self.total_iterations
                             / max(len(self.iter_history), 1)),
            total_time_s=sum(self.step_times),
            mean_step_time_s=sum(self.step_times) / n,
            max_step_time_s=max(self.step_times, default=0.0),
        )
        if self.step_times and self.total_iterations:
            out["iterations_per_s"] = (self.total_iterations
                                       / sum(self.step_times))
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(dict(summary=self.summary(),
                           iter_history=self.iter_history,
                           step_times=self.step_times), f)
