"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled with ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``dlp_admm_torch/csrc/`` into ``dlp_admm_torch/_build/``
(listed in ``.gitignore``), under a file name keyed on a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not. A
library may add flags of its own (``-D...``), so one source can be built
once per element type, the compilers running side by side. The
libraries have a plain C interface and are loaded with ``ctypes``; nothing
here includes PyTorch's headers, so a build takes seconds.

Nothing is built or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or the
    toolkit's default prefix. Raises if there is none."""
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str, sources, flags=()) -> Path:
    """Where the library built from ``sources`` with the extra ``flags``
    lives (content-keyed)."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *flags)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, sources, flags=()):
    """Start ``nvcc`` for one library unless it exists: ``(path, tmp, cmd,
    process or None)``."""
    out = library_path(name, sources, flags)
    if out.exists():
        return out, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
           *map(str, sources)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, cmd, proc


def _finish(out, tmp, cmd, proc) -> str:
    """Wait for the compiler and return its output, which is kept beside the
    library so that a later call that finds the library finds it too."""
    log_path = out.with_suffix(".log")
    if proc is None:
        return log_path.read_text() if log_path.exists() else ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{log}")
    # atomic, the log first: a concurrent build or a rank that loads the
    # library sees all of both or none
    tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, out)
    return log


def build_all(libraries: dict) -> dict:
    """Compile each ``name -> (sources, flags)`` into ``lib<name>_<hash>.so``
    unless it exists, one ``nvcc`` per library, all started together.
    Returns each library's compiler output (register and shared-memory use
    per kernel from ``-Xptxas -v``), from this build or the one that made
    the library."""
    started = {name: _start(name, *lib) for name, lib in libraries.items()}
    logs, errors = {}, []
    for name, job in started.items():        # every process is waited for
        try:
            logs[name] = _finish(*job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return logs


def build(name: str, sources, flags=()) -> tuple[Path, str]:
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless it exists.
    Returns the path and the compiler's output."""
    log = build_all({name: (sources, flags)})[name]
    return library_path(name, sources, flags), log


def load(name: str, sources, flags=()) -> ctypes.CDLL:
    """Build if needed, then load (once per process) the library."""
    path, _ = build(name, sources, flags)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
