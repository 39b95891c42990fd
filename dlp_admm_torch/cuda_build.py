"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled with ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``dlp_admm_torch/csrc/`` into ``dlp_admm_torch/_build/``
(listed in ``.gitignore``), under a file name keyed on a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not. The
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


def library_path(name: str, sources) -> Path:
    """Where the library built from ``sources`` lives (content-keyed)."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources) -> tuple[Path, str]:
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless it exists.
    Returns the path and the compiler's output (register and shared-memory
    use per kernel from ``-Xptxas -v``; empty when nothing was built)."""
    out = library_path(name, sources)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: a concurrent builder sees all or none
    return out, proc.stdout + proc.stderr


def load(name: str, sources) -> ctypes.CDLL:
    """Build if needed, then load (once per process) the library."""
    path, _ = build(name, sources)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
