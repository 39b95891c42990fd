"""Batched symmetric block-tridiagonal solve: the CUDA kernels and their plain
PyTorch version.

Port of the Pallas kernel ``dlp_admm_tpu/solvers/thomas_pallas.py``
(``block_thomas_solve_pallas`` / ``_thomas_kernel``): block Thomas with
Gauss-Jordan elimination on each stage's ``[C_k | U_k | g_k]`` and every
pivot floored at +-1e-30 (sign kept). ``diag [S, T, B, B]``,
``upper [S, T-1 or T, B, B]`` (entry T-1 ignored; the subdiagonal is
``upper^T``), ``rhs [S, T, B]`` -> ``[S, T, B]``, float32 or float64.

Unlike the Pallas kernel, the elimination swaps rows (partial pivoting, the
first largest entry of the pivot column), as the JAX package's per-stage LU
does: the flagship's stage blocks are saddle-point KKT matrices, which an
unpivoted elimination may not factor. Where no swap is needed the two agree.

With ``equilibrate=True`` each stage solve is what
``dlp_admm_tpu/solvers/linalg.py::equil_solve`` is to the JAX package's
float32 stage solve: ``d = 1/sqrt(max(rowmax|C_k|, 1e-30))``, eliminate
``(D C D) Y = D [U_k | g_k]``, one refinement pass on the scaled system,
``X = D Y``. It stays one kernel launch per solve.

Four kernels, chosen by the block width (:func:`kernel_plan`):

* ``warp`` (``csrc/block_thomas_warp.cu``, compiled once per element type),
  B <= 32: one warp per system, the augmented tile in registers, no block
  barrier inside a pivot step;
* ``wide`` (``csrc/block_thomas_wide.cu``, compiled once per element type),
  32 < B <= 97 in float64 and <= 138 in float32 (equilibrated: <= 80 and
  <= 106): one thread block per system, the tile in registers (warp w owns
  rows, lane l columns l, l+32, ...), one block barrier a pivot step;
* ``cluster`` (``csrc/block_thomas_cluster.cu``, compiled once per element
  type), past the wide kernel's classes up to what a thread-block cluster
  holds on chip (float64 B <= 384, float32 <= 528 on an H100): one cluster
  of 2-16 CTAs per system, the tile split by 16-column blocks over their
  shared memory, Gauss-Jordan by panels of 16 columns with one cluster
  barrier a panel (each entry taking the plain elimination's operations in
  their order), the stage products on the float64 tensor cores;
* ``big`` (``csrc/block_thomas_big.cu``, compiled once per element type),
  every width past the cluster's reach: the cluster kernel's blocks and
  order of work over a grid of co-resident CTAs per system (one a panel
  and one more, each holding a C and a [U | g] block: 27 at 405, 39 at
  605; past 768 in float64 and 1568 in float32 the blocks live in a
  device workspace), each panel published through L2 behind a flag, the CTAs
  looping over systems where the card does not hold them all at once; a
  cooperative launch.

:func:`block_thomas_solve` takes the plain version for tensors on the CPU and
launches a kernel for tensors on a CUDA device; there is no fallback between
the two, nor from one kernel to the other. :data:`launches` counts kernel
launches, :data:`launches_by_variant` by kernel, element type and variant
(:func:`variant_name`), and :data:`launches_by_kernel` sums those by kernel.
"""
from __future__ import annotations

import ctypes
from collections.abc import Mapping

import torch

from .. import cuda_build

PIVOT_FLOOR = 1e-30
KERNELS = ("warp", "wide", "cluster", "big")
_WARP_SRC = (cuda_build.CSRC_DIR / "block_thomas_warp.cu",)
_WIDE_SRC = (cuda_build.CSRC_DIR / "block_thomas_wide.cu",)
_BIG_SRC = (cuda_build.CSRC_DIR / "block_thomas_big.cu",)
_CLUSTER_SRC = (cuda_build.CSRC_DIR / "block_thomas_cluster.cu",)
_F64 = ("-DBLOCK_THOMAS_REAL=double",)
_F32 = ("-DBLOCK_THOMAS_REAL=float",)
# library -> (sources, extra nvcc flags); one compiler each, side by side
LIBRARIES = {
    "block_thomas_warp_f64": (_WARP_SRC, _F64),
    "block_thomas_warp_f32": (_WARP_SRC, _F32),
    "block_thomas_wide_f64": (_WIDE_SRC, _F64),
    "block_thomas_wide_f32": (_WIDE_SRC, _F32),
    "block_thomas_big_f64": (_BIG_SRC, _F64),
    "block_thomas_big_f32": (_BIG_SRC, _F32),
    "block_thomas_cluster_f64": (_CLUSTER_SRC, _F64),
    "block_thomas_cluster_f32": (_CLUSTER_SRC, _F32),
}
WARP_MAX_B = 32
WARP_WIDTHS = (20, 32)      # width bounds the warp kernel is compiled for
WARP_MAX_WARPS = 4          # systems per block, at most
# the wide kernel's width classes: bound -> (column slots a lane holds of
# each row, then rows a warp holds and how many of the last slots live in
# shared memory instead of registers, unequilibrated and equilibrated; None
# where the equilibrated variant is not built), as in
# csrc/block_thomas_wide.cu. A class with bound BP launches ceil(B / rows)
# warps, and 2 BP + 1 <= 32 slots.
WIDE_CLASSES = {
    torch.float64: {48: (4, (4, 0), (4, 0)), 64: (5, (4, 0), (8, 0)),
                    80: (6, (5, 0), (10, 2)), 97: (7, (4, 2), None)},
    torch.float32: {48: (4, (4, 0), (4, 0)), 64: (5, (4, 0), (4, 0)),
                    80: (6, (5, 0), (5, 0)), 97: (7, (4, 2), (14, 4)),
                    106: (7, (4, 2), (14, 4)), 138: (9, (5, 4), None)},
}
WIDE_PROFILE_BP = 80        # the class the profiling build is compiled for
BIG_THREADS = 256           # threads a CTA of the big kernel
CLUSTER_THREADS = 256       # threads a CTA of the cluster kernel
CLUSTER_NB = 16             # its panel and column-block width
CLUSTER_LDB = CLUSTER_NB + 1    # a block's row stride in shared memory
CLUSTER_MAX = 16            # CTAs a cluster, at most (past 8: non-portable)
CLUSTER_MAX_BLOCKS = 6      # column blocks a CTA holds, at most
# an H100's per-block shared-memory limit and SM count: kernel_plan's
# defaults when no device is asked (the CPU tests)
H100_SMEM_LIMIT = 232448
H100_SM_COUNT = 132

# kernel launches made by block_thomas_solve / launch_kernel or by replaying
# a CUDA graph that holds them, by variant (:func:`variant_name`; a bare
# kernel name counts for its kernel alone), so a run can show it went
# through the kernels; the plain version does not count
launches = 0
launches_by_variant: dict = {}
# launches recorded into CUDA graphs under stream capture (not yet launched)
captured_by_variant: dict = {}

_limits: dict = {}


class _ByKernel(Mapping):
    """A count by variant, read as the sum over each kernel's variants (the
    first word of a variant's name)."""

    def __init__(self, by_variant: dict):
        self._by_variant = by_variant

    def __getitem__(self, name: str) -> int:
        if name not in KERNELS:
            raise KeyError(name)
        return sum(n for v, n in self._by_variant.items()
                   if v.split()[0] == name)

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)

    def __repr__(self) -> str:
        return repr(dict(self))


launches_by_kernel = _ByKernel(launches_by_variant)
captured = _ByKernel(captured_by_variant)


def variant_name(kernel: str, dtype: torch.dtype, equilibrate: bool) -> str:
    """The key of :data:`launches_by_variant`: ``"warp f64 eq"``, say."""
    return (f"{kernel} f{torch.finfo(dtype).bits}"
            f"{' eq' if equilibrate else ''}")


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    launches_by_variant.clear()


def _count(variants: dict) -> None:
    global launches
    for name, n in variants.items():
        if n:
            launches_by_variant[name] = launches_by_variant.get(name, 0) + n
            launches += n


def replay(graph, variants: dict) -> None:
    """Replay a captured CUDA graph that holds ``variants[name]`` launches
    of each variant (the growth of :data:`captured_by_variant` during its
    capture)."""
    graph.replay()
    _count(variants)


def _gauss_jordan(c: torch.Tensor, m: torch.Tensor,
                  pivots: list | None = None) -> torch.Tensor:
    """``C^-1 M`` for ``c [S, B, B]``, ``m [S, B, M]`` by the kernels'
    elimination: row j swaps with the first row i >= j of largest
    ``|aug[i, j]|`` (a NaN counts as the largest), the pivot is floored, row
    i subtracts its multiplier ``aug[i, j] / pivot`` times the pivot row,
    and the pivot row is scaled by the same reciprocal. ``pivots``, if
    given, receives each step's pivot row position ``[S]``."""
    s, b = c.shape[0], c.shape[1]
    floor = torch.full((s,), PIVOT_FLOOR, dtype=c.dtype, device=c.device)
    rows = torch.arange(b, device=c.device)
    aug = torch.cat([c, m], dim=-1)
    for j in range(b):
        p = (j + torch.argmax(aug[:, j:, j].abs(), dim=1))[:, None]
        if pivots is not None:
            pivots.append(p[:, 0].clone())
        perm = torch.where(rows == j, p, torch.where(rows == p, j, rows))
        aug = torch.gather(aug, 1, perm[..., None].expand(aug.shape))
        pjj = aug[:, j, j]
        pjj = torch.where(pjj.abs() > PIVOT_FLOOR, pjj,
                          torch.where(pjj >= 0, floor, -floor))
        inv = (1.0 / pjj)[:, None]
        row = aug[:, j, :]
        aug = aug - (aug[:, :, j] * inv)[:, :, None] * row[:, None, :]
        aug[:, j, :] = row * inv
    return aug[:, :, b:]


def _equil_solve(c: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-max equilibrated stage solve with one refinement pass on the
    scaled system (``linalg.equil_solve`` of the JAX package, with the
    kernels' elimination in place of its LU)."""
    d = 1.0 / torch.sqrt(torch.clamp(c.abs().amax(dim=-1), min=PIVOT_FLOOR))
    a_s = c * d[:, :, None] * d[:, None, :]
    m_s = m * d[:, :, None]
    y = _gauss_jordan(a_s, m_s)
    y = y + _gauss_jordan(a_s, m_s - a_s @ y)
    return y * d[:, :, None]


def block_thomas_plain(diag: torch.Tensor, upper: torch.Tensor,
                       rhs: torch.Tensor,
                       equilibrate: bool = False) -> torch.Tensor:
    """The kernels' function in plain batched PyTorch (same recursion, same
    pivot choice, same pivot floor, same equilibration and refinement)."""
    t, b = rhs.shape[1], rhs.shape[2]
    solve = _equil_solve if equilibrate else _gauss_jordan
    xs, ys = [], []
    x_prev = y_prev = None
    for k in range(t):
        c_k, g_k = diag[:, k], rhs[:, k]
        if k > 0:
            u_t = upper[:, k - 1].transpose(-1, -2)
            c_k = c_k - u_t @ x_prev
            g_k = g_k - (u_t @ y_prev[..., None])[..., 0]
        u_k = upper[:, k] if k < t - 1 else torch.zeros_like(c_k)
        sol = solve(c_k, torch.cat([u_k, g_k[..., None]], dim=-1))
        x_prev, y_prev = sol[:, :, :b], sol[:, :, b]
        xs.append(x_prev)
        ys.append(y_prev)
    z = torch.zeros_like(rhs[:, 0])
    out = [None] * t
    for k in range(t - 1, -1, -1):
        z = ys[k] - (xs[k] @ z[..., None])[..., 0]
        out[k] = z
    return torch.stack(out, dim=1)


# -- launch layouts (plain Python: the CPU tests reach them) -----------------

def warp_elems(b: int, bp: int, t: int, equilibrate: bool,
               hist_in_smem: bool) -> int:
    """Shared-memory elements one warp of the warp kernel needs (the layout
    of ``warp_elems`` in ``csrc/block_thomas_warp.cu``)."""
    n = b * b + b + 2 * b * b + b * (bp + 1)
    if equilibrate:
        n += b * (2 * bp + 1)
    if hist_in_smem:
        n += t * b * (bp + 1)
    return n


def wide_elems(b: int, nw: int, ncl: int, rpw: int, nt: int) -> int:
    """Shared-memory elements one block of the wide kernel holds: the
    double-buffered candidate rows of its ``nw`` warps ``[2, nw, 32 ncl]``
    and every row's entry in the coming pivot column ``[2, nw rpw]``,
    ``X_k | y_k`` ``[B, B+1]``, the row scales and the reciprocal pivots
    ``[2, B]`` and the tile's last ``nt`` column slots ``[nt, nw rpw, 32]``."""
    return (2 * nw * (32 * ncl + rpw) + b * (b + 1) + 2 * b
            + nt * nw * rpw * 32)


def wide_bytes(b: int, elem: int, nw: int, ncl: int, rpw: int,
               nt: int) -> int:
    """Shared-memory bytes of one block of the wide kernel (``wide_bytes``
    in ``csrc/block_thomas_wide.cu``): candidate keys, positions and rows
    (512 + 512 bytes), the pivot rows ``int[B]`` rounded up to 16 bytes,
    then :func:`wide_elems` elements."""
    return 1024 + -(-4 * b // 16) * 16 + elem * wide_elems(b, nw, ncl, rpw,
                                                           nt)


def cluster_blocks(b: int, r: int) -> tuple[int, int, int]:
    """(Bp, C blocks, [U | g] blocks) of the cluster kernel: B padded to
    16 columns, and the column blocks the CTA that holds the most of them
    holds in a cluster of ``r`` (C block q and [U | g] block q on CTA
    q mod r; g is [U | g] block Bp / 16)."""
    bp = -(-b // CLUSTER_NB) * CLUSTER_NB
    nq = bp // CLUSTER_NB
    return bp, -(-nq // r), (nq + r) // r


def cluster_bytes(b: int, elem: int, r: int, prefetch: bool) -> int:
    """Shared-memory bytes of one CTA of the cluster kernel
    (``cluster_bytes`` in ``csrc/block_thomas_cluster.cu``): one tile, or
    two where the next stage is prefetched, of its blocks ``[Bp][17]``, a
    panel's pivot-row values for each block ``[16][17]``, the row maxima
    and scales ``[2, Bp]``, the multipliers of the rows a panel's swaps
    touch ``[32][17]``, rounded up to 16 bytes; then every panel's pivot
    rows ``int[Bp]`` rounded up to 16 bytes, the 4 factor warps' pivot
    candidates (8-byte keys, 4-byte rows, ``[2, 4]``: 96 bytes), and a
    panel's pivot rows, the rows its swaps touch, where each pivot row is
    among them, and their count (``int[68]``: 272 bytes)."""
    bp, mc, mr = cluster_blocks(b, r)
    n = ((2 if prefetch else 1) * (mc + mr) * bp * CLUSTER_LDB
         + (mc + mr) * CLUSTER_NB * CLUSTER_LDB + 2 * bp
         + 2 * CLUSTER_NB * CLUSTER_LDB)
    return -(-elem * n // 16) * 16 + -(-4 * bp // 16) * 16 + 96 + 272


def big_bytes(b: int, elem: int, r: int, prefetch: bool,
              tile_in_smem: bool) -> int:
    """Shared-memory bytes of one CTA of the big kernel in a grid of ``r``
    CTAs a system (``big_bytes`` in ``csrc/block_thomas_big.cu``): its
    blocks ``[Bp][17]``, one tile or two where the next stage is
    prefetched, where they live there (``tile_in_smem``), a panel's
    pivot-row values for each block ``[16][17]``, the row maxima and scales
    ``[2, Bp]``, the multipliers of the rows a panel's swaps touch
    ``[32][17]``, rounded up to 16 bytes; then the 4 factor warps' pivot
    candidates (96 bytes), a panel's pivot rows, the rows its swaps touch,
    where each pivot row is among them and their count (``int[68]``: 272
    bytes), and the pivot rows of the panel the CTA factors (64 bytes)."""
    bp, mc, mr = cluster_blocks(b, r)
    tile = ((2 if prefetch else 1) * (mc + mr) * bp * CLUSTER_LDB
            if tile_in_smem else 0)
    n = (tile + (mc + mr) * CLUSTER_NB * CLUSTER_LDB + 2 * bp
         + 2 * CLUSTER_NB * CLUSTER_LDB)
    return -(-elem * n // 16) * 16 + 96 + 272 + 64


def big_sync_ints(b: int) -> int:
    """Ints of one group's sync workspace of the big kernel (``sync_ints``
    in ``csrc/block_thomas_big.cu``): each panel's pivot rows
    ``[nq, 16]``, its flag ``[nq]`` and the barrier count, rounded up to
    32 (128 bytes)."""
    nq = -(-b // CLUSTER_NB)
    return -(-(nq * (CLUSTER_NB + 1) + 1) // 32) * 32


def big_ctas(b: int, elem: int, smem_limit: int = H100_SMEM_LIMIT,
             sm_count: int = H100_SM_COUNT) -> tuple | None:
    """(CTAs a system, prefetch, blocks in shared memory) of the big
    kernel for width ``b``, or None past its reach: one CTA a panel and one
    more (at most the SMs), so that a CTA holds one C block and one
    [U | g] block; the blocks in its shared memory where they fit, the next
    stage prefetched where two tiles fit, else in a device workspace, as
    long as what stays in shared memory fits. (Fewer CTAs with more blocks
    each also fit up to 768 in float64, but are slower: 35.0 against 21.8
    ms at 605 in float32, equilibrated, on an H100;
    ``tools/time_big_ctas.py``, PERF.md.)"""
    r = min(-(-b // CLUSTER_NB) + 1, sm_count)
    if big_bytes(b, elem, r, False, True) <= smem_limit:
        return r, big_bytes(b, elem, r, True, True) <= smem_limit, True
    if big_bytes(b, elem, r, False, False) <= smem_limit:
        return r, False, False
    return None


def cluster_size(b: int, elem: int,
                 smem_limit: int = H100_SMEM_LIMIT) -> tuple | None:
    """(CTAs a cluster, prefetch) for width ``b``, or None past the
    cluster's reach: the smallest power of two that gives each CTA at most
    two of the panels (and at least 2 CTAs), doubled while a CTA's blocks
    do not fit the limit, up to 16; the next stage is prefetched where two
    tiles fit."""
    nq = -(-b // CLUSTER_NB)
    r = 2
    while r < min(-(-nq // 2), CLUSTER_MAX):
        r *= 2
    while r <= CLUSTER_MAX:
        _, mc, mr = cluster_blocks(b, r)
        if (mc + mr <= CLUSTER_MAX_BLOCKS
                and cluster_bytes(b, elem, r, False) <= smem_limit):
            return r, cluster_bytes(b, elem, r, True) <= smem_limit
        r *= 2
    return None


def wide_classes(dtype: torch.dtype, equilibrate: bool) -> dict:
    """Bound -> (ncl, rpw, nt) of the wide kernel's classes built for
    ``dtype`` and the variant."""
    return {bp: (ncl,) + (eq if equilibrate else plain)
            for bp, (ncl, plain, eq) in WIDE_CLASSES[dtype].items()
            if not (equilibrate and eq is None)}


def kernel_plan(s: int, t: int, b: int, dtype: torch.dtype,
                equilibrate: bool = False, kernel: str | None = None,
                smem_limit: int = H100_SMEM_LIMIT,
                sm_count: int = H100_SM_COUNT,
                co_resident: int | None = None) -> dict:
    """Which kernel solves ``S`` systems of ``T`` stages of width ``B`` and
    how it is launched.

    ``kernel`` is chosen by width unless given: ``"warp"`` for B <= 32,
    ``"wide"`` up to its classes' widths, then ``"cluster"`` as far as a
    cluster holds the tile on chip, else ``"big"``. The warp kernel
    spreads the systems over the SMs one warp each before it packs up to 4
    warps into a block, and keeps every stage's ``X_k | y_k`` in shared
    memory where that fits the limit, else in global scratch. The cluster
    kernel launches ``S * cluster`` CTAs in clusters of ``cluster``
    (:func:`cluster_size`). The big kernel runs a grid of ``ctas`` CTAs a
    system (:func:`big_ctas`) in ``groups`` groups, as many systems at once
    as ``co_resident`` CTAs (what the device holds at once; one an SM unless
    given) allow, each group looping over its systems. Raises
    ``ValueError`` for a width the named kernel does not hold, or a grid
    whose CTAs the device cannot hold at once.
    """
    elem = torch.finfo(dtype).bits // 8
    classes = wide_classes(dtype, equilibrate)

    def fit(x):         # the narrowest wide class that holds width x
        return next((bp for bp in sorted(classes) if x <= bp and
                     wide_bytes(x, elem, -(-x // classes[bp][1]),
                                *classes[bp]) <= smem_limit), None)
    if kernel is None:
        kernel = ("warp" if b <= WARP_MAX_B else
                  "wide" if fit(b) is not None else
                  "cluster" if cluster_size(b, elem, smem_limit) else "big")
    if kernel == "cluster":
        size = cluster_size(b, elem, smem_limit)
        if size is None:
            raise ValueError(f"B={b} in {dtype} is past what a cluster of "
                             f"{CLUSTER_MAX} CTAs holds in shared memory")
        r, prefetch = size
        bp, mc, mr = cluster_blocks(b, r)
        return dict(kernel="cluster", cluster=r, prefetch=prefetch,
                    threads=CLUSTER_THREADS, blocks=s * r, padded=bp,
                    panels=bp // CLUSTER_NB, c_blocks=mc, rhs_blocks=mr,
                    smem_bytes=cluster_bytes(b, elem, r, prefetch))
    if kernel == "big":
        size = big_ctas(b, elem, smem_limit, sm_count)
        if size is None:
            need = big_bytes(b, elem, min(-(-b // CLUSTER_NB) + 1, sm_count),
                             False, False)
            raise ValueError(f"B={b} in {dtype} needs {need} bytes of shared "
                             f"memory a CTA beside the big kernel's blocks; "
                             f"this device allows {smem_limit}")
        r, prefetch, tile_in_smem = size
        co_resident = sm_count if co_resident is None else co_resident
        if r > co_resident:
            raise ValueError(f"B={b} in {dtype}: the big kernel's {r} CTAs a "
                             f"system are not co-resident on this device "
                             f"({co_resident} at once)")
        groups = min(s, co_resident // r)
        bp, mc, mr = cluster_blocks(b, r)
        return dict(kernel="big", ctas=r, groups=groups, blocks=groups * r,
                    threads=BIG_THREADS, padded=bp, panels=bp // CLUSTER_NB,
                    c_blocks=mc, rhs_blocks=mr, prefetch=prefetch,
                    tile_in_smem=tile_in_smem, co_resident=co_resident,
                    smem_bytes=big_bytes(b, elem, r, prefetch, tile_in_smem))
    if kernel == "wide":
        bp = fit(b)
        if bp is None:
            b_max = max(x for x in range(1, max(classes) + 1) if fit(x))
            raise ValueError(
                f"block width B={b} is past the wide kernel's register tile "
                f"and shared memory: B <= {b_max} in {dtype}"
                f"{' equilibrated' if equilibrate else ''}")
        ncl, rpw, nt = classes[bp]
        nw = -(-b // rpw)
        return dict(kernel="wide", bp=bp, ncl=ncl, rpw=rpw, nt=nt, warps=nw,
                    blocks=s, threads=32 * nw,
                    smem_bytes=wide_bytes(b, elem, nw, ncl, rpw, nt))
    if kernel != "warp":
        raise ValueError(f"unknown kernel {kernel!r}")
    if b > WARP_MAX_B:
        raise ValueError(f"the warp kernel holds B <= {WARP_MAX_B}, got {b}")
    bp = next(w for w in WARP_WIDTHS if b <= w)
    warps = max(1, min(WARP_MAX_WARPS, -(-s // sm_count)))
    for hist_in_smem in (True, False):
        for n_w in range(warps, 0, -1):
            need = n_w * elem * warp_elems(b, bp, t, equilibrate, hist_in_smem)
            if need <= smem_limit:
                return dict(kernel="warp", bp=bp, warps=n_w,
                            blocks=-(-s // n_w), threads=32 * n_w,
                            hist_in_smem=hist_in_smem, smem_bytes=need)
    raise ValueError(f"B={b}, T={t} in {dtype} needs {need} bytes of shared "
                     f"memory per warp; this device allows {smem_limit}")


# -- the libraries -----------------------------------------------------------

def library_name(kernel: str, dtype: torch.dtype) -> str:
    """The library that holds ``kernel`` for ``dtype``."""
    return f"block_thomas_{kernel}_" + (
        "f64" if dtype == torch.float64 else "f32")


def _lib(name: str):
    lib = cuda_build.load(name, *LIBRARIES[name])
    if not getattr(lib, "_typed", False):
        ptr, i32, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        if name.startswith("block_thomas_cluster"):
            lib.block_thomas_cluster.argtypes = [ptr] * 9 + [i32] * 7 + [
                sz, ptr]
            lib.block_thomas_cluster.restype = i32
            lib.block_thomas_cluster_max_active.argtypes = [i32] * 4 + [
                ctypes.POINTER(ctypes.c_int)]
            lib.block_thomas_cluster_max_active.restype = i32
            elem_bytes = lib.block_thomas_cluster_elem_bytes
        elif name.startswith("block_thomas_big"):
            lib.block_thomas_big.argtypes = [ptr] * 13 + [i32] * 9 + [
                sz, ptr]
            lib.block_thomas_big.restype = i32
            lib.block_thomas_big_max_active.argtypes = [i32] * 5 + [
                ctypes.POINTER(ctypes.c_int)]
            lib.block_thomas_big_max_active.restype = i32
            lib.block_thomas_big_smem_bytes.argtypes = [i32] * 4
            lib.block_thomas_big_smem_bytes.restype = sz
            lib.block_thomas_big_sync_ints.argtypes = [i32]
            lib.block_thomas_big_sync_ints.restype = sz
            elem_bytes = lib.block_thomas_big_elem_bytes
        elif name.startswith("block_thomas_wide"):
            lib.block_thomas_wide.argtypes = [ptr] * 7 + [i32] * 6 + [sz, ptr]
            lib.block_thomas_wide.restype = i32
            lib.block_thomas_wide_profile.argtypes = (
                [ptr] * 8 + [i32] * 4 + [sz, ptr])
            lib.block_thomas_wide_profile.restype = i32
            elem_bytes = lib.block_thomas_wide_elem_bytes
        else:
            lib.block_thomas_warp.argtypes = (
                [ptr] * 5 + [i32] * 8 + [sz, ptr])
            lib.block_thomas_warp.restype = i32
            lib.block_thomas_warp_profile.argtypes = (
                [ptr] * 6 + [i32] * 6 + [sz, ptr])
            lib.block_thomas_warp_profile.restype = i32
            elem_bytes = lib.block_thomas_warp_elem_bytes
        elem_bytes.argtypes = []
        elem_bytes.restype = i32
        if elem_bytes() != (8 if name.endswith("f64") else 4):
            raise RuntimeError(f"{name} was built for another type")
        lib._typed = True
    return lib


def build() -> dict:
    """Build (or find) every library, the compilers running side by side;
    returns each library's compiler output (``-Xptxas -v``)."""
    logs = cuda_build.build_all(LIBRARIES)
    for name in LIBRARIES:
        _lib(name)
    return logs


def device_limits(device) -> tuple[int, int]:
    """(shared memory a block may opt in to, SM count) of a CUDA device,
    asked once per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    lim = _limits.get(index)
    if lim is None:
        props = torch.cuda.get_device_properties(index)
        lim = _limits[index] = (
            getattr(props, "shared_memory_per_block_optin", H100_SMEM_LIMIT),
            props.multi_processor_count)
    return lim


def cluster_max_active(b: int, dtype: torch.dtype, equilibrate: bool,
                       device="cuda") -> int:
    """How many clusters of the cluster kernel's plan for width ``b`` the
    device runs at once (``cudaOccupancyMaxActiveClusters``); a launch of
    ``S`` systems runs in ``ceil(S / that)`` waves."""
    smem_limit, sm_count = device_limits(device)
    plan = kernel_plan(1, 1, b, dtype, equilibrate, "cluster", smem_limit,
                       sm_count)
    lib = _lib(library_name("cluster", dtype))
    count = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        rc = lib.block_thomas_cluster_max_active(
            b, plan["cluster"], int(plan["prefetch"]), int(equilibrate),
            ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {rc}")
    return count.value


def big_co_resident(b: int, dtype: torch.dtype, equilibrate: bool,
                    device="cuda") -> int:
    """How many CTAs of the big kernel's plan for width ``b`` the device
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times
    its SMs), asked once per plan."""
    smem_limit, sm_count = device_limits(device)
    plan = kernel_plan(1, 1, b, dtype, equilibrate, "big", smem_limit,
                       sm_count)
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, b, dtype, equilibrate)
    if key not in _limits:
        lib = _lib(library_name("big", dtype))
        count = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = lib.block_thomas_big_max_active(
                b, plan["ctas"], int(plan["prefetch"]),
                int(plan["tile_in_smem"]), int(equilibrate),
                ctypes.byref(count))
        if rc != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor"
                               f" failed: {rc}")
        _limits[key] = count.value
    return _limits[key]


def _check(diag, upper, rhs):
    if rhs.dim() != 3:
        raise ValueError(f"rhs must be [S, T, B], got {tuple(rhs.shape)}")
    s, t, b = rhs.shape
    if min(s, t, b) < 1:
        raise ValueError(f"rhs must be non-empty, got {tuple(rhs.shape)}")
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


def launch_kernel(diag: torch.Tensor, upper: torch.Tensor, rhs: torch.Tensor,
                  equilibrate: bool = False, kernel: str | None = None,
                  profile: bool = False):
    """Launch one kernel on CUDA tensors (on the current stream) and return
    its output; ``kernel`` overrides the choice by width, for measurements.

    ``profile=True`` (float64 unequilibrated or float32 equilibrated; the
    warp kernel for B <= 20, the wide kernel for 32 < B <= 80, the cluster
    kernel and the big kernel at any width they hold) also returns ``[S, 6]``
    int64 clocks per
    system spent in (warp kernel: load, equilibrate, elimination,
    refinement, storing ``X_k | y_k`` and the product for the next stage,
    back substitution; wide kernel: load and the product of the stage,
    equilibrate, elimination, refinement, storing ``X_k | y_k``, back
    substitution), and for the cluster kernel ``[S, cluster, 6]``, each
    CTA's clocks in the panel factors, the cluster barriers (waits for the
    CTA's own warps included), the panel updates (and the refinement's),
    the stage product (and the equilibrated variant's scaling and
    residual), the copies in and out, and the back substitution (the first
    CTA); for the big kernel ``[S, ctas, 6]``, the same with the flag and
    barrier waits in place of the cluster barriers.
    Under stream capture the launch is recorded into the graph and
    counted in :data:`captured_by_variant`; :func:`replay` counts it when it
    runs.
    """
    _check(diag, upper, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"no block-Thomas kernel for device {rhs.device}")
    for name, x in (("diag", diag), ("upper", upper), ("rhs", rhs)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s, t, b = rhs.shape
    elem = rhs.element_size()
    smem_limit, sm_count = device_limits(rhs.device)
    plan = kernel_plan(s, t, b, rhs.dtype, equilibrate, kernel, smem_limit,
                       sm_count)
    if plan["kernel"] == "big":
        plan = kernel_plan(s, t, b, rhs.dtype, equilibrate, "big",
                           smem_limit, sm_count, big_co_resident(
                               b, rhs.dtype, equilibrate, rhs.device))
    name = plan["kernel"]
    lib = _lib(library_name(name, rhs.dtype))
    out = torch.empty_like(rhs)
    prof = None
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream(rhs.device).cuda_stream
        if name == "warp":
            hist = None if plan["hist_in_smem"] else torch.empty(
                (s, t, b, plan["bp"] + 1), dtype=rhs.dtype, device=rhs.device)
            args = (diag.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
                    out.data_ptr(), None if hist is None else hist.data_ptr())
            if profile:
                if plan["bp"] != WARP_WIDTHS[0] or equilibrate != (
                        rhs.dtype == torch.float32):
                    raise ValueError(
                        "the profiling kernel is built for B <= 20, float64 "
                        "unequilibrated or float32 equilibrated")
                prof = torch.zeros((s, 6), dtype=torch.int64,
                                   device=rhs.device)
                rc = lib.block_thomas_warp_profile(
                    *args, prof.data_ptr(), s, t, b, upper.shape[1],
                    plan["warps"], int(plan["hist_in_smem"]),
                    plan["smem_bytes"], stream)
            else:
                rc = lib.block_thomas_warp(
                    *args, s, t, b, upper.shape[1], int(equilibrate),
                    plan["bp"], plan["warps"], int(plan["hist_in_smem"]),
                    plan["smem_bytes"], stream)
        elif name == "cluster":
            # scratch: every stage's X_k | y_k and, equilibrated, the scaled
            # stage system A_s | M_s and the first solution Y (padded); the
            # kernel writes each element before reading it
            xs = torch.empty_like(diag)
            ys = torch.empty_like(rhs)
            bp, r = plan["padded"], plan["cluster"]
            wr = bp + CLUSTER_NB
            orig = torch.empty((s, bp, bp + wr), dtype=rhs.dtype,
                               device=rhs.device) if equilibrate else None
            ysc = torch.empty((s, bp, wr), dtype=rhs.dtype,
                              device=rhs.device) if equilibrate else None
            if profile:
                prof = torch.zeros((s, r, 6), dtype=torch.int64,
                                   device=rhs.device)
            rc = lib.block_thomas_cluster(
                diag.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
                out.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                None if orig is None else orig.data_ptr(),
                None if ysc is None else ysc.data_ptr(),
                None if prof is None else prof.data_ptr(), s, t, b,
                upper.shape[1], int(equilibrate), r, int(plan["prefetch"]),
                plan["smem_bytes"], stream)
        elif name == "big":
            # scratch: every stage's X_k | y_k, each group's published
            # panels, its blocks where they do not fit shared memory and,
            # equilibrated, the scaled stage system, the first solution and
            # each CTA's row maxima (the kernel writes each element before
            # reading it); the flags and barrier counts start at zero (a
            # memset, also in a captured graph)
            if profile and not plan["tile_in_smem"]:
                raise ValueError(f"the big kernel's profiling build keeps its "
                                 f"blocks in shared memory; B={b} does not")
            xs = torch.empty_like(diag)
            ys = torch.empty_like(rhs)
            bp, r, g = plan["padded"], plan["ctas"], plan["groups"]
            wr = bp + CLUSTER_NB

            def scratch(*shape):
                return torch.empty(shape, dtype=rhs.dtype, device=rhs.device)
            panels = scratch(g, bp // CLUSTER_NB, bp, CLUSTER_NB)
            sync = torch.zeros((g, big_sync_ints(b)), dtype=torch.int32,
                               device=rhs.device)
            tiles = None if plan["tile_in_smem"] else scratch(
                g * r, plan["c_blocks"] + plan["rhs_blocks"], bp,
                CLUSTER_LDB)
            orig, ysc, rmaxw = ((scratch(g, bp, bp + wr), scratch(g, bp, wr),
                                 scratch(g, r, bp)) if equilibrate
                                else (None, None, None))
            if profile:
                prof = torch.zeros((s, r, 6), dtype=torch.int64,
                                   device=rhs.device)
            rc = lib.block_thomas_big(
                diag.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
                out.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                *(None if x is None else x.data_ptr()
                  for x in (orig, ysc, rmaxw, panels, tiles, sync, prof)),
                s, t, b, upper.shape[1], int(equilibrate), r, g,
                int(plan["prefetch"]), int(plan["tile_in_smem"]),
                plan["smem_bytes"], stream)
        else:
            # scratch: every stage's X_k | y_k and, equilibrated, the scaled
            # stage system and every pivot step's multipliers (rows of the
            # block's warps); the kernel writes each element before reading
            # it
            xs = torch.empty_like(diag)
            ys = torch.empty_like(rhs)
            if profile:
                ncl, rpw, nt = wide_classes(rhs.dtype, equilibrate)[
                    WIDE_PROFILE_BP]
            else:
                ncl, rpw, nt = plan["ncl"], plan["rpw"], plan["nt"]
            rows = -(-b // rpw) * rpw
            orig = torch.empty((s, b * (2 * b + 1) + b * rows),
                               dtype=rhs.dtype, device=rhs.device
                               ) if equilibrate else None
            args = (diag.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
                    out.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                    None if orig is None else orig.data_ptr())
            if profile:
                if not 32 < b <= WIDE_PROFILE_BP or equilibrate != (
                        rhs.dtype == torch.float32):
                    raise ValueError(
                        "the wide profiling kernel is built for 32 < B <= 80, "
                        "float64 unequilibrated or float32 equilibrated")
                prof = torch.zeros((s, 6), dtype=torch.int64,
                                   device=rhs.device)
                rc = lib.block_thomas_wide_profile(
                    *args, prof.data_ptr(), s, t, b, upper.shape[1],
                    wide_bytes(b, elem, -(-b // rpw), ncl, rpw, nt), stream)
            else:
                rc = lib.block_thomas_wide(
                    *args, s, t, b, upper.shape[1], int(equilibrate),
                    plan["bp"], plan["smem_bytes"], stream)
    if rc != 0:
        raise RuntimeError(f"block_thomas_{name} launch failed: code {rc} "
                           f"(a cudaError, or -1 arguments, -2 layout, -3 "
                           f"CTAs not co-resident)")
    variant = variant_name(name, rhs.dtype, equilibrate)
    if torch.cuda.is_current_stream_capturing():
        captured_by_variant[variant] = captured_by_variant.get(variant, 0) + 1
    else:
        _count({variant: 1})
    return (out, prof) if profile else out


def block_thomas_solve(diag: torch.Tensor, upper: torch.Tensor,
                       rhs: torch.Tensor,
                       equilibrate: bool = False) -> torch.Tensor:
    """Solve ``S`` symmetric block-tridiagonal systems (see module doc).

    CPU tensors go through :func:`block_thomas_plain`; CUDA tensors launch
    the kernel :func:`kernel_plan` names (:func:`launch_kernel`), or raise.
    """
    if rhs.device.type == "cpu":
        _check(diag, upper, rhs)
        return block_thomas_plain(diag, upper, rhs, equilibrate)
    return launch_kernel(diag, upper, rhs, equilibrate)
