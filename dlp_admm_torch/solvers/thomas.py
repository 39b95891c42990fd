"""Batched symmetric block-tridiagonal solve: the CUDA kernel and its plain
PyTorch version.

Port of the Pallas kernel ``dlp_admm_tpu/solvers/thomas_pallas.py``
(``block_thomas_solve_pallas`` / ``_thomas_kernel``): block Thomas with
Gauss-Jordan elimination on each stage's ``[C_k | U_k | g_k]`` and every
pivot floored at +-1e-30 (sign kept). ``diag [S, T, B, B]``,
``upper [S, T-1 or T, B, B]`` (entry T-1 ignored; the subdiagonal is
``upper^T``), ``rhs [S, T, B]`` -> ``[S, T, B]``, float32 or float64.

Unlike the Pallas kernel, the elimination swaps rows (partial pivoting, the
first largest entry of the pivot column), as the JAX package's float64
per-stage LU does: the flagship's stage blocks are saddle-point KKT
matrices, which an unpivoted elimination may not factor
(``csrc/block_thomas.cu`` says more). Where no swap is needed the two agree.

:func:`block_thomas_solve` takes the plain version for tensors on the CPU and
launches ``csrc/block_thomas.cu`` for tensors on a CUDA device; there is no
fallback between the two. :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

PIVOT_FLOOR = 1e-30
SOURCES = (cuda_build.CSRC_DIR / "block_thomas.cu",)

# kernel launches made by block_thomas_solve or by replaying a CUDA graph
# that holds it (a run can show it went through the kernel); the plain
# version does not count
launches = 0
# kernels recorded into CUDA graphs under stream capture (not yet launched)
captured = 0


def replay(graph, kernels: int) -> None:
    """Replay a captured CUDA graph that holds ``kernels`` of this kernel's
    launches (counted by :data:`captured` during its capture)."""
    global launches
    graph.replay()
    launches += kernels


def block_thomas_plain(diag: torch.Tensor, upper: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain batched PyTorch (same recursion, same
    pivot choice, same pivot floor)."""
    s, t, b = rhs.shape
    floor = torch.full((s,), PIVOT_FLOOR, dtype=rhs.dtype, device=rhs.device)
    rows = torch.arange(b, device=rhs.device)
    xs, ys = [], []
    x_prev = y_prev = None
    for k in range(t):
        c_k, g_k = diag[:, k], rhs[:, k]
        if k > 0:
            u_t = upper[:, k - 1].transpose(-1, -2)
            c_k = c_k - u_t @ x_prev
            g_k = g_k - (u_t @ y_prev[..., None])[..., 0]
        u_k = upper[:, k] if k < t - 1 else torch.zeros_like(c_k)
        aug = torch.cat([c_k, u_k, g_k[..., None]], dim=-1)   # [S, B, 2B+1]
        for j in range(b):
            # swap row j with the first row i >= j of largest |aug[i, j]|
            p = (j + torch.argmax(aug[:, j:, j].abs(), dim=1))[:, None]
            perm = torch.where(rows == j, p, torch.where(rows == p, j, rows))
            aug = torch.gather(aug, 1, perm[..., None].expand(aug.shape))
            pjj = aug[:, j, j]
            pjj = torch.where(pjj.abs() > PIVOT_FLOOR, pjj,
                              torch.where(pjj >= 0, floor, -floor))
            piv = aug[:, j, :] / pjj[:, None]
            aug = aug - aug[:, :, j, None] * piv[:, None, :]
            aug[:, j, :] = piv
        x_prev, y_prev = aug[:, :, b:2 * b], aug[:, :, 2 * b]
        xs.append(x_prev)
        ys.append(y_prev)
    z = torch.zeros_like(rhs[:, 0])
    out = [None] * t
    for k in range(t - 1, -1, -1):
        z = ys[k] - (xs[k] @ z[..., None])[..., 0]
        out[k] = z
    return torch.stack(out, dim=1)


def _lib():
    lib = cuda_build.load("block_thomas", SOURCES)
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.block_thomas_f64, lib.block_thomas_f32):
            fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            fn.restype = i32
        lib.block_thomas_smem_bytes.argtypes = [i32, i32]
        lib.block_thomas_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def build() -> str:
    """Build (or find) the kernel's library; returns the compiler output."""
    _, log = cuda_build.build("block_thomas", SOURCES)
    _lib()
    return log


def _check(diag, upper, rhs):
    if rhs.dim() != 3:
        raise ValueError(f"rhs must be [S, T, B], got {tuple(rhs.shape)}")
    s, t, b = rhs.shape
    if tuple(diag.shape) != (s, t, b, b):
        raise ValueError(f"diag must be {(s, t, b, b)}, got {tuple(diag.shape)}")
    if (upper.dim() != 4 or upper.shape[0] != s or upper.shape[1] not in
            (t - 1, t) or tuple(upper.shape[2:]) != (b, b)):
        raise ValueError(f"upper must be [{s}, {t - 1} or {t}, {b}, {b}], "
                         f"got {tuple(upper.shape)}")
    if not (diag.dtype == upper.dtype == rhs.dtype) or rhs.dtype not in (
            torch.float32, torch.float64):
        raise TypeError("diag, upper, rhs must share dtype float32 or float64, "
                        f"got {diag.dtype}, {upper.dtype}, {rhs.dtype}")
    if not (diag.device == upper.device == rhs.device):
        raise ValueError("diag, upper, rhs must lie on one device, got "
                         f"{diag.device}, {upper.device}, {rhs.device}")


def block_thomas_solve(diag: torch.Tensor, upper: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``S`` symmetric block-tridiagonal systems (see module doc).

    CPU tensors go through :func:`block_thomas_plain`; CUDA tensors launch
    the kernel (one thread block per system) on the current stream, or raise.
    Under stream capture the launch is recorded into the graph and counted
    in :data:`captured`; :func:`replay` counts it when it runs.
    """
    global launches, captured
    _check(diag, upper, rhs)
    if rhs.device.type == "cpu":
        return block_thomas_plain(diag, upper, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"no block-Thomas kernel for device {rhs.device}")
    for name, x in (("diag", diag), ("upper", upper), ("rhs", rhs)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s, t, b = rhs.shape
    lib = _lib()
    elem = rhs.element_size()
    props = torch.cuda.get_device_properties(rhs.device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    need = lib.block_thomas_smem_bytes(b, elem)
    if need > limit:
        b_max = b
        while lib.block_thomas_smem_bytes(b_max, elem) > limit:
            b_max -= 1
        raise ValueError(
            f"block width B={b} needs {need} bytes of shared memory per block; "
            f"this device allows {limit}, so B <= {b_max} in {rhs.dtype}")
    out = torch.empty_like(rhs)
    xs = torch.empty_like(diag)
    ys = torch.empty_like(rhs)
    fn = lib.block_thomas_f64 if rhs.dtype == torch.float64 \
        else lib.block_thomas_f32
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream(rhs.device).cuda_stream
        rc = fn(diag.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
                out.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                s, t, b, upper.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"block_thomas kernel launch failed: cudaError {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
