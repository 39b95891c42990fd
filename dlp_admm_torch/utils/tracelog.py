"""Python binding of the native trace logger (port of
``dlp_admm_tpu/utils/tracelog.py``).

``native/tracelog.cpp`` buffers fixed-size float32 records in memory and
flushes them from a background thread, so per-step telemetry never stalls
the loop that dispatches the device work. Its shared library is compiled at
first use with ``g++`` into ``dlp_admm_torch/_build/`` (listed in
``.gitignore``), under a name keyed on a hash of the source and flags, and
loaded with ``ctypes``; where no compiler is found, a pure-Python writer
with the same file format is used. The format is the JAX package's: a
16-byte header (magic ``0x444C5031``, ``u32`` record width, ``u64``
reserved) and then the records, so either package reads the other's files.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..cuda_build import BUILD_DIR, PKG_DIR

SOURCE = PKG_DIR.parent / "native" / "tracelog.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")
_MAGIC = 0x444C5031
_lib_state: dict = {}


def library_path() -> Path:
    """Where the library built from ``native/tracelog.cpp`` lives
    (content-keyed)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtracelog_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)        # atomic: a concurrent build sees all or none
    return out


def _lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded once per process; ``None``
    where it cannot be built or loaded."""
    if "lib" in _lib_state:
        return _lib_state["lib"]
    lib = None
    path = _build()
    if path is not None:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            lib = None
    if lib is not None:
        lib.tl_open.restype = ctypes.c_void_p
        lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.tl_append.restype = ctypes.c_int
        lib.tl_append.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_uint32]
        lib.tl_flush.restype = ctypes.c_int
        lib.tl_flush.argtypes = [ctypes.c_void_p]
        lib.tl_records.restype = ctypes.c_uint64
        lib.tl_records.argtypes = [ctypes.c_void_p]
        lib.tl_close.restype = ctypes.c_int
        lib.tl_close.argtypes = [ctypes.c_void_p]
        lib.tl_read.restype = ctypes.c_int64
        lib.tl_read.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint32)]
    _lib_state["lib"] = lib
    return lib


def native_available() -> bool:
    """Whether the native library is built and loaded (it is built on the
    first call)."""
    return _lib() is not None


class TraceLog:
    """Append-only fixed-width float32 record log.

    >>> log = TraceLog("run.dlplog", record_floats=8)
    >>> log.append(np.zeros((4, 8), np.float32))
    >>> log.close()
    >>> read_tracelog("run.dlplog").shape
    (4, 8)
    """

    def __init__(self, path: str, record_floats: int):
        self.path = path
        self.record_floats = int(record_floats)
        self._handle = None
        self._file = None
        lib = _lib()
        if lib is not None:
            self._handle = lib.tl_open(path.encode(), self.record_floats)
        if self._handle is None:  # pure-Python writer, same format
            self._file = open(path, "wb")
            self._file.write(struct.pack("<IIQ", _MAGIC, self.record_floats,
                                         0))

    def append(self, records: np.ndarray) -> None:
        rec = np.ascontiguousarray(records, np.float32).reshape(
            -1, self.record_floats)
        if self._handle is not None:
            ptr = rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if _lib().tl_append(self._handle, ptr, rec.shape[0]) != 0:
                raise IOError("tl_append failed")
        else:
            self._file.write(rec.tobytes())

    def flush(self) -> None:
        if self._handle is not None:
            _lib().tl_flush(self._handle)
        else:
            self._file.flush()

    @property
    def n_records(self) -> int:
        if self._handle is not None:
            return int(_lib().tl_records(self._handle))
        return (self._file.tell() - 16) // (4 * self.record_floats)

    def close(self) -> None:
        if self._handle is not None:
            _lib().tl_close(self._handle)
            self._handle = None
        elif self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tracelog(path: str) -> np.ndarray:
    """Read a trace log back as ``[n_records, record_floats]`` float32."""
    lib = _lib()
    if lib is not None:
        rf = ctypes.c_uint32(0)
        n = lib.tl_read(path.encode(), None, 0, ctypes.byref(rf))
        if n < 0:
            raise IOError(f"tl_read failed ({n}) for {path}")
        out = np.empty((n, rf.value), np.float32)
        got = lib.tl_read(path.encode(),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          n, ctypes.byref(rf))
        return out[:got]
    with open(path, "rb") as f:
        magic, rf, _ = struct.unpack("<IIQ", f.read(16))
        if magic != _MAGIC:
            raise IOError(f"bad magic in {path}")
        return np.frombuffer(f.read(), np.float32).reshape(-1, rf)
