"""The port's native trace logger and ``RunMetrics`` streaming, against the
JAX package's reader and writer, on the CPU.

``dlp_admm_torch.utils.tracelog`` compiles ``native/tracelog.cpp`` with
``g++`` into the port's build directory; both packages write and read the
same file format, so a log written by either is read by the other. Records
are float32 and compared bit for bit.
"""
import os

import numpy as np
import pytest

from dlp_admm_torch.utils import RunMetrics, tracelog
from dlp_admm_torch.utils.tracelog import (TraceLog, native_available,
                                           read_tracelog)
from dlp_admm_tpu.utils import tracelog as jtracelog


def test_native_library_builds():
    """The C++ writer is built and in use here."""
    assert native_available()
    assert tracelog.library_path().exists()


def test_roundtrip(tmp_path):
    data = np.random.default_rng(0).normal(size=(257, 9)).astype(np.float32)
    path = str(tmp_path / "run.dlplog")
    with TraceLog(path, 9) as log:
        log.append(data[:100])
        log.append(data[100:])
        assert log.n_records == 257
        log.flush()
    np.testing.assert_array_equal(read_tracelog(path), data)


def test_high_rate_append(tmp_path):
    """64k records through the buffered writer."""
    data = np.ones((1024, 16), np.float32)
    path = str(tmp_path / "hr.dlplog")
    with TraceLog(path, 16) as log:
        for _ in range(64):
            log.append(data)
    back = read_tracelog(path)
    assert back.shape == (64 * 1024, 16)
    assert float(back.sum()) == 64 * 1024 * 16


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_logs_cross_between_packages(tmp_path, writer):
    """A log written by one package reads back equal in the other."""
    data = np.random.default_rng(1).normal(size=(33, 5)).astype(np.float32)
    path = str(tmp_path / f"{writer}.dlplog")
    w, r = ((TraceLog, jtracelog.read_tracelog) if writer == "torch"
            else (jtracelog.TraceLog, read_tracelog))
    with w(path, 5) as log:
        log.append(data)
    np.testing.assert_array_equal(r(path), data)


def test_python_writer_keeps_the_format(tmp_path, monkeypatch):
    """Without the native library the pure-Python writer and reader are
    used; the JAX package reads their file."""
    monkeypatch.setattr(tracelog, "_lib_state", {"lib": None})
    assert not native_available()
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = str(tmp_path / "py.dlplog")
    with TraceLog(path, 4) as log:
        log.append(data[:1])
        log.append(data[1:])
        assert log.n_records == 3
    np.testing.assert_array_equal(read_tracelog(path), data)
    np.testing.assert_array_equal(jtracelog.read_tracelog(path), data)


def test_log_step_streams_records(tmp_path):
    """``RunMetrics(trace_path=...)`` streams ``[step, iterations, extras
    sorted by key, zero padding]``, as the JAX version does: the two files
    are equal."""
    from dlp_admm_tpu.utils.metrics import RunMetrics as JRunMetrics
    paths = []
    for cls in (RunMetrics, JRunMetrics):
        path = str(tmp_path / f"{cls.__module__.split('.')[0]}.dlplog")
        m = cls(trace_path=path)
        m.log_step(0, 5, rho=1.5, primal=0.25, note="text")
        m.log_step(1, 7, rho=2.0, primal=0.125, note="text")
        m.close()
        assert m.iter_history == [5, 7]
        paths.append(path)
    back = read_tracelog(paths[0])
    np.testing.assert_array_equal(back, [[0, 5, 0.25, 1.5, 0, 0, 0, 0],
                                         [1, 7, 0.125, 2.0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(back, jtracelog.read_tracelog(paths[1]))


def test_without_a_trace_path_nothing_is_written(tmp_path):
    m = RunMetrics()
    m.log_step(0, 3, rho=1.0)
    m.close()
    assert m._trace is None and not os.listdir(tmp_path)
