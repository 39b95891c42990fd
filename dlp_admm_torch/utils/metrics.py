"""Run metrics, timing and observability (port of
``dlp_admm_tpu/utils/metrics.py``).

:class:`RunMetrics` keeps the per-step history and the aggregate report of
one MPC run, with the same keys as the JAX version, and with ``trace_path``
streams every logged step through the native trace logger
(:mod:`.tracelog`). :func:`trace` wraps a block in ``torch.profiler`` and
writes a Chrome trace (the JAX version's ``jax.profiler.trace``).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("dlp_admm_torch")


@dataclass
class RunMetrics:
    """Per-step history + aggregate report of one MPC run.

    ``trace_path`` streams every logged step through the native buffered
    trace logger as fixed-width float32 records ``[step, iterations,
    extras... (sorted by key; those that are not numbers left out),
    zero-padded to trace_record_floats]``; :meth:`close` flushes it, and
    :func:`~dlp_admm_torch.utils.tracelog.read_tracelog` reads it back.
    """

    step_times: List[float] = field(default_factory=list)
    iter_history: List[int] = field(default_factory=list)     # `iter_his`
    extras: Dict[str, list] = field(default_factory=dict)
    trace_path: Optional[str] = None
    trace_record_floats: int = 8
    _trace: Optional[object] = field(default=None, repr=False)

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
        if self.trace_path is not None:
            self._trace_step(step, iterations, kv)

    def _trace_step(self, step, iterations, kv):
        import numpy as np
        if self._trace is None:
            from .tracelog import TraceLog
            self._trace = TraceLog(self.trace_path, self.trace_record_floats)
        vals = [float(step), float(iterations)]
        for k in sorted(kv):
            try:
                vals.append(float(kv[k]))
            except (TypeError, ValueError):
                pass
        vals = (vals + [0.0] * self.trace_record_floats)[
            :self.trace_record_floats]
        self._trace.append(np.asarray([vals], np.float32))

    def close(self) -> None:
        """Flush and close the trace stream (nothing without one)."""
        if self._trace is not None:
            self._trace.close()
            self._trace = None

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


@contextlib.contextmanager
def trace(name: str, enabled: bool = False, trace_dir: Optional[str] = None):
    """``torch.profiler`` around the block (the counterpart of the JAX
    version's ``jax.profiler.trace``): host operations and, where a CUDA
    card is present, its kernels, written as a Chrome trace to
    ``trace_dir/<name>.json`` (``trace_dir`` defaults to
    ``dlp_admm_torch_trace`` in the temporary directory). Yields that path,
    or ``None`` when not ``enabled``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                          "dlp_admm_torch_trace")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s (%s)", path, name)
