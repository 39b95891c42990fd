"""The block-Thomas kernel's plain PyTorch version against the JAX package,
and the CUDA kernel against the plain version (on a card only).

References:
* ``thomas_pallas.block_thomas_solve_pallas`` run as the JAX package runs it
  on the CPU (Pallas interpret mode), on diagonally dominant systems, where
  partial pivoting swaps no rows: the same recursion with the same pivot
  floor, so only summation order differs — 1e-12 in float64, 1e-5
  (relative to the solution's scale) in float32;
* vmapped ``ip_staged.block_thomas_solve`` (LU with partial pivoting per
  stage, float64): the same solution of a well-posed system, reached by
  another elimination — 1e-9 relative on diagonally dominant systems and on
  saddle systems with a zero leading block (which need row swaps), 1e-7 on
  KKT-style saddle systems (condition ~1e8 from the -1e-8 blocks);
* the same vmapped solve in float32, where it equilibrates and refines each
  stage solve (``linalg.equil_solve``), against the plain version with
  ``equilibrate=True``: the same scaling and refinement around another
  elimination (pivoted Gauss-Jordan against LU), so both carry float32
  rounding of their own — solutions within 1e-5 relative where the system
  is well conditioned; on badly scaled systems (condition ~1e9, where a
  float32 solution is not determined to that level) the componentwise
  scaled residual ``|Ax - r| / (|A||x| + |r|)``, below 2e-6 and no more
  than 4 times the JAX solve's.

The launch layouts of the four kernels (:func:`thomas.kernel_plan`) are plain
Python and are checked here, and so is the cluster kernel's order of work
(Gauss-Jordan by panels of 16 columns, emulated in numpy) against the plain
elimination. The CUDA kernels themselves are held against the plain version
in ``tests/test_torch_cuda.py``, which imports no JAX so it runs on the
card.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dlp_admm_torch.solvers import thomas
from dlp_admm_tpu.solvers.ip_staged import block_thomas_solve as jax_thomas
from dlp_admm_tpu.solvers.thomas_pallas import block_thomas_solve_pallas


def make_system(seed, s, t, b, kind="diag_dominant"):
    """Symmetric block-tridiagonal systems (numpy float64), the generator
    ``chip_smoke.py`` uses on the card."""
    return chip_smoke.make_system(np.random.default_rng(seed), s, t, b, kind)


def _dense(diag, upper):
    t, b = diag.shape[0], diag.shape[1]
    m = np.zeros((t * b, t * b))
    for k in range(t):
        m[k * b:(k + 1) * b, k * b:(k + 1) * b] = diag[k]
        if k + 1 < t:
            m[k * b:(k + 1) * b, (k + 1) * b:(k + 2) * b] = upper[k]
            m[(k + 1) * b:(k + 2) * b, k * b:(k + 1) * b] = upper[k].T
    return m


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_plain_matches_pallas_interpret(dtype, tol):
    diag, upper, rhs = (a.astype(dtype) for a in make_system(0, 4, 7, 19))
    want = np.asarray(block_thomas_solve_pallas(
        jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    got = thomas.block_thomas_plain(*(torch.as_tensor(a)
                                      for a in (diag, upper, rhs))).numpy()
    assert got.dtype == dtype
    assert _rel(got, want) < tol, _rel(got, want)


@pytest.mark.parametrize("shape", [(2, 7, 19), (1, 7, 20)])
@pytest.mark.parametrize("kind,tol", [("diag_dominant", 1e-9),
                                      ("kkt_saddle", 1e-7),
                                      ("zero_lead", 1e-9)])
def test_plain_matches_pivoted_lu_thomas(shape, kind, tol):
    diag, upper, rhs = make_system(1, *shape, kind=kind)
    want = np.asarray(jax.vmap(jax_thomas)(
        jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    # the wrapper takes the plain version for CPU tensors
    got = thomas.block_thomas_solve(*(torch.as_tensor(a)
                                      for a in (diag, upper, rhs))).numpy()
    assert _rel(got, want) < tol, _rel(got, want)
    # and it solves the system
    for s in range(shape[0]):
        res = _dense(diag[s], upper[s]) @ got[s].reshape(-1) - rhs[s].ravel()
        assert np.abs(res).max() < 1e-8 * np.abs(rhs).max()


def test_upper_with_t_minus_1_blocks():
    """``upper`` may carry T-1 blocks; entry T-1 of a T-block upper is
    ignored."""
    diag, upper, rhs = (torch.as_tensor(a) for a in make_system(2, 3, 5, 6))
    full = thomas.block_thomas_solve(diag, upper, rhs)
    short = thomas.block_thomas_solve(diag, upper[:, :-1].contiguous(), rhs)
    torch.testing.assert_close(full, short, rtol=0, atol=0)


def test_pivot_floor_keeps_zero_pivot_finite():
    diag = torch.zeros(1, 2, 3, 3, dtype=torch.float64)
    upper = torch.zeros(1, 2, 3, 3, dtype=torch.float64)
    out = thomas.block_thomas_plain(diag, upper,
                                    torch.ones(1, 2, 3, dtype=torch.float64))
    assert torch.isfinite(out).all()
    assert float(out.abs().max()) == pytest.approx(1e30)    # 1 / floor


def test_cpu_tensors_do_not_launch():
    before = thomas.launches
    thomas.block_thomas_solve(*(torch.as_tensor(a)
                                for a in make_system(3, 2, 7, 19)))
    assert thomas.launches == before


def test_wrapper_rejects_bad_inputs():
    d, u, r = (torch.as_tensor(a) for a in make_system(4, 2, 4, 5))
    with pytest.raises(ValueError):
        thomas.block_thomas_solve(d[:, :3], u, r)           # diag shape
    with pytest.raises(ValueError):
        thomas.block_thomas_solve(d, u[:, :2], r)           # upper length
    with pytest.raises(TypeError):
        thomas.block_thomas_solve(d.float(), u, r)          # mixed dtypes
    with pytest.raises(TypeError):
        thomas.block_thomas_solve(*(a.to(torch.int64) for a in (d, u, r)))
    # no kernel, no fallback for other devices
    with pytest.raises(ValueError, match="no block-Thomas kernel"):
        thomas.block_thomas_solve(*(a.to("meta") for a in (d, u, r)))


# -- the equilibrated variant (the float32 stage solve) ----------------------

def _scaled_residual(diag, upper, rhs, x):
    """max over systems and rows of |Ax - r| / (|A||x| + |r|), in float64."""
    worst = 0.0
    for s in range(diag.shape[0]):
        a = _dense(diag[s].astype(np.float64), upper[s].astype(np.float64))
        xs, rs = x[s].reshape(-1).astype(np.float64), rhs[s].reshape(-1)
        res = np.abs(a @ xs - rs) / (np.abs(a) @ np.abs(xs) + np.abs(rs))
        worst = max(worst, float(res.max()))
    return worst


@pytest.mark.parametrize("shape", [(2, 7, 19), (1, 7, 20), (2, 4, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["diag_dominant", "kkt_saddle",
                                  "badly_scaled"])
def test_equilibrated_plain_matches_jax_float32(shape, kind):
    diag, upper, rhs = (a.astype(np.float32)
                        for a in make_system(8, *shape, kind=kind))
    want = np.asarray(jax.vmap(jax_thomas)(
        jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    got = thomas.block_thomas_solve(
        *(torch.as_tensor(a) for a in (diag, upper, rhs)),
        equilibrate=True).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    if kind == "badly_scaled":
        res, res_jax = (_scaled_residual(diag, upper, rhs, x)
                        for x in (got, want))
        assert res < 2e-6 and res < 4 * res_jax, (res, res_jax)
    else:
        assert _rel(got, want) < 1e-5, _rel(got, want)


def test_equilibration_matters_on_badly_scaled_float32():
    """The unequilibrated float32 elimination leaves a scaled residual an
    order of magnitude above the equilibrated one on rows of 1e6 beside
    rows of 1 (so the test above could not pass without the scaling)."""
    diag, upper, rhs = (a.astype(np.float32)
                        for a in make_system(8, 2, 4, 40, "badly_scaled"))
    args = [torch.as_tensor(a) for a in (diag, upper, rhs)]
    raw = thomas.block_thomas_plain(*args).numpy()
    eq = thomas.block_thomas_plain(*args, equilibrate=True).numpy()
    assert (_scaled_residual(diag, upper, rhs, raw)
            > 10 * _scaled_residual(diag, upper, rhs, eq))


def test_equilibrated_plain_float64_solves_and_floors():
    diag, upper, rhs = make_system(9, 2, 5, 12, "badly_scaled")
    got = thomas.block_thomas_plain(
        *(torch.as_tensor(a) for a in (diag, upper, rhs)),
        equilibrate=True).numpy()
    assert _scaled_residual(diag, upper, rhs, got) < 1e-14
    # a singular block: the row scale and the pivots are floored, and the
    # output is not a finite solution the caller could mistake for one
    z = torch.zeros(1, 2, 3, 3, dtype=torch.float64)
    out = thomas.block_thomas_plain(z, z, torch.ones(1, 2, 3,
                                                     dtype=torch.float64),
                                    equilibrate=True)
    assert not bool((out.abs() < 1e20).all())


# -- launch layouts (no card needed) -----------------------------------------

@pytest.mark.parametrize("b,kernel,bp", [(1, "warp", 20), (19, "warp", 20),
                                         (20, "warp", 20), (21, "warp", 32),
                                         (32, "warp", 32), (33, "wide", None),
                                         (61, "wide", None)])
def test_kernel_plan_dispatches_on_width(b, kernel, bp):
    plan = thomas.kernel_plan(2, 7, b, torch.float64)
    assert plan["kernel"] == kernel
    assert plan["smem_bytes"] <= thomas.H100_SMEM_LIMIT
    if kernel == "warp":
        assert plan["bp"] == bp and plan["threads"] == 32 * plan["warps"]
        assert plan["blocks"] * plan["warps"] >= 2
    else:
        assert plan["blocks"] == 2 and plan["threads"] == 32 * plan["warps"]
        assert plan["warps"] == -(-b // plan["rpw"]) <= 32


def test_kernel_plan_spreads_systems_before_it_packs_warps():
    one = thomas.kernel_plan(2, 7, 19, torch.float64)
    assert (one["warps"], one["blocks"]) == (1, 2)
    many = thomas.kernel_plan(256, 7, 19, torch.float64)
    assert (many["warps"], many["blocks"]) == (2, 128)
    full = thomas.kernel_plan(4096, 7, 19, torch.float32)
    assert full["warps"] == thomas.WARP_MAX_WARPS and full["blocks"] == 1024


def test_kernel_plan_shared_memory_layout():
    # flagship local shape in float64: D_k, r_k, two U_k, X_k|y_k and the
    # seven stages' X_k|y_k, rows padded to the width bound 20 plus y
    plan = thomas.kernel_plan(2, 7, 19, torch.float64)
    assert plan["hist_in_smem"]
    assert plan["smem_bytes"] == 8 * (3 * 361 + 19 + 8 * 19 * 21)
    eq = thomas.kernel_plan(2, 7, 19, torch.float32, equilibrate=True)
    assert eq["smem_bytes"] == 4 * (3 * 361 + 19 + 8 * 19 * 21 + 19 * 41)
    # a long chain no longer fits beside the tile: its X_k|y_k go to scratch
    long = thomas.kernel_plan(1, 400, 32, torch.float64)
    assert not long["hist_in_smem"]
    assert long["smem_bytes"] == 8 * thomas.warp_elems(32, 32, 400, False,
                                                       False)
    # the wide kernel: keys, positions and rows of the candidates (1024
    # bytes), the pivot rows int[61] rounded to 16 bytes, the candidate rows
    # [2, 16 warps, 32 lanes x 5 columns] and pivot-column entries
    # [2, 16 warps x 4 rows], X_k|y_k [61, 62], the row scales and the
    # reciprocal pivots; the equilibrated variant keeps its scaled system
    # and multipliers in device scratch and runs 8 rows a warp (8 warps)
    w = thomas.kernel_plan(1, 7, 61, torch.float64)
    w_eq = thomas.kernel_plan(1, 7, 61, torch.float64, equilibrate=True)
    assert (w["bp"], w["ncl"], w["rpw"], w["nt"], w["warps"]) == (
        64, 5, 4, 0, 16)
    assert w["smem_bytes"] == (
        1024 + 256 + 8 * (2 * 16 * (160 + 4) + 61 * 62 + 2 * 61))
    assert (w_eq["rpw"], w_eq["warps"]) == (8, 8)
    assert w_eq["smem_bytes"] == (
        1024 + 256 + 8 * (2 * 8 * (160 + 8) + 61 * 62 + 2 * 61))
    # the float64 97 class keeps its last two column slots in shared
    # memory: [2, 25 warps x 4 rows, 32 lanes]
    w97 = thomas.kernel_plan(1, 7, 97, torch.float64)
    assert (w97["ncl"], w97["rpw"], w97["nt"], w97["warps"]) == (7, 4, 2, 25)
    # the equilibrated variant of the float64 80 class: 10 rows a warp,
    # the last two column slots in shared memory
    eq80 = thomas.kernel_plan(1, 7, 80, torch.float64, True)
    assert (eq80["rpw"], eq80["nt"], eq80["warps"]) == (10, 2, 8)
    assert w97["smem_bytes"] == 1024 + 400 + 8 * (
        2 * 25 * (224 + 4) + 97 * 98 + 2 * 97 + 2 * 25 * 4 * 32)


@pytest.mark.parametrize("dtype,equilibrate,b_max", [
    (torch.float64, False, 97), (torch.float64, True, 80),
    (torch.float32, False, 138), (torch.float32, True, 106)])
def test_kernel_plan_raises_past_shared_memory(dtype, equilibrate, b_max):
    """Past the wide kernel's widest class the cluster kernel takes over;
    the wide kernel, asked for by name, still raises there."""
    assert thomas.kernel_plan(1, 7, b_max, dtype, equilibrate)[
        "kernel"] == "wide"
    assert thomas.kernel_plan(1, 7, b_max + 1, dtype, equilibrate)[
        "kernel"] == "cluster"
    with pytest.raises(ValueError, match=f"B <= {b_max}"):
        thomas.kernel_plan(1, 7, b_max + 1, dtype, equilibrate,
                           kernel="wide")


def test_kernel_plan_override_and_its_checks():
    assert thomas.kernel_plan(2, 7, 19, torch.float64, kernel="wide")[
        "kernel"] == "wide"
    with pytest.raises(ValueError, match="B <= 32"):
        thomas.kernel_plan(2, 7, 40, torch.float64, kernel="warp")
    with pytest.raises(ValueError, match="unknown kernel"):
        thomas.kernel_plan(2, 7, 19, torch.float64, kernel="block")


def test_launch_counts_reset():
    thomas._count({"warp": 2, "wide": 1, "cluster": 1, "big": 1})
    assert thomas.launches >= 5
    thomas.reset_counts()
    assert thomas.launches == 0
    assert thomas.launches_by_kernel == {"warp": 0, "wide": 0, "cluster": 0,
                                         "big": 0}


# the wide kernel's layout over its whole range: widths 33-97 (float64) and
# 33-138 (float32), equilibrated 33-80 and 33-106

# the widths the block-per-system kernel of the earlier layout held (its
# tile in shared memory): nothing may be narrower now
EARLIER_WIDE_MAX = {(torch.float64, False): 97, (torch.float64, True): 75,
                    (torch.float32, False): 138, (torch.float32, True): 106}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("equilibrate", [False, True], ids=["plain", "eq"])
def test_wide_plan_over_its_range(dtype, equilibrate):
    elem = torch.empty((), dtype=dtype).element_size()
    classes = thomas.wide_classes(dtype, equilibrate)
    assert set(classes) <= set(thomas.WIDE_CLASSES[dtype])
    b_max = max(classes)
    assert b_max >= EARLIER_WIDE_MAX[dtype, equilibrate]
    for b in range(33, b_max + 1):
        plan = thomas.kernel_plan(3, 7, b, dtype, equilibrate)
        bp, ncl, rpw, nt = plan["bp"], plan["ncl"], plan["rpw"], plan["nt"]
        assert plan["kernel"] == "wide" and plan["blocks"] == 3
        # the narrowest class that holds B, and B's row fits 32 lanes
        assert bp == min(x for x in classes if x >= b)
        assert (ncl, rpw, nt) == classes[bp] and 2 * bp + 1 <= 32 * ncl
        assert plan["warps"] * rpw >= b > (plan["warps"] - 1) * rpw
        assert plan["threads"] == 32 * plan["warps"] <= 1024
        assert plan["smem_bytes"] == thomas.wide_bytes(
            b, elem, plan["warps"], ncl, rpw, nt) <= thomas.H100_SMEM_LIMIT
    with pytest.raises(ValueError, match=f"B <= {b_max}"):
        thomas.kernel_plan(1, 7, b_max + 1, dtype, equilibrate,
                           kernel="wide")


def test_wide_plan_raises_with_the_largest_width_that_fits():
    """On a device with less shared memory the wide kernel's error names
    the largest width any class still holds there, and that width is
    planned; every width past it goes to the cluster kernel, which spreads
    its tile over more CTAs than on an H100."""
    limit = 64 * 1024
    with pytest.raises(ValueError, match=r"B <= (\d+)") as err:
        thomas.kernel_plan(1, 7, 97, torch.float64, kernel="wide",
                           smem_limit=limit)
    b_max = int(err.value.args[0].rsplit("B <= ", 1)[1].split()[0])
    plan = thomas.kernel_plan(1, 7, b_max, torch.float64, smem_limit=limit)
    assert plan["kernel"] == "wide" and plan["smem_bytes"] <= limit
    for b in range(b_max + 1, 98):
        with pytest.raises(ValueError):
            thomas.kernel_plan(1, 7, b, torch.float64, kernel="wide",
                               smem_limit=limit)
        plan = thomas.kernel_plan(1, 7, b, torch.float64, smem_limit=limit)
        assert plan["kernel"] == "cluster" and plan["smem_bytes"] <= limit


def _first_largest_rule(c):
    """The pivot rows the kernels' rule picks on one matrix ``c [B, B]``
    (numpy, rows swapped explicitly): at step j the first position i >= j
    of the largest |a_ij|, a NaN above everything."""
    a = np.array(c, dtype=np.float64)
    b = a.shape[0]
    order = []
    for j in range(b):
        col = np.abs(a[j:, j])
        nan = np.flatnonzero(np.isnan(col))
        p = j + (nan[0] if len(nan) else int(np.flatnonzero(
            col == col.max())[0]))
        order.append(p)
        a[[j, p]] = a[[p, j]]
        piv = a[j, j] if abs(a[j, j]) > thomas.PIVOT_FLOOR else (
            thomas.PIVOT_FLOOR if a[j, j] >= 0 else -thomas.PIVOT_FLOOR)
        f = a[:, j] / piv
        row = a[j].copy()
        a -= f[:, None] * row[None, :]
        a[j] = row / piv
    return order


@pytest.mark.parametrize("case", ["ties", "nan"])
def test_plain_pivot_order_follows_the_kernels_rule(case):
    """Exact ties (small integers, many equal entries in a column) and a NaN
    in a pivot column: the plain version picks the pivot rows the kernels
    implement (first largest by position; a NaN wins)."""
    rng = np.random.default_rng(12)
    b = 40
    c = rng.integers(-2, 3, size=(2, b, b)).astype(np.float64)
    c[:, :, 0] = 1.0                     # column 0: a tie over every row
    c[:, 5:9, 1] = 7.0                   # column 1: a tie below the top
    if case == "nan":
        c[1, 6, 0] = np.nan
    pivots = []
    thomas._gauss_jordan(torch.as_tensor(c), torch.zeros(2, b, 1,
                                                         dtype=torch.float64),
                         pivots)
    got = torch.stack(pivots, 1).numpy()
    for s in range(2):
        want = _first_largest_rule(c[s])
        if case == "nan" and s == 1:
            assert want[0] == 6
            assert got[s, 0] == 6
        else:
            assert want[0] == 0              # the first of the tie
            np.testing.assert_array_equal(got[s], want)


# -- the cluster kernel (widths past the wide classes) ------------------------

# the widest B a cluster of 16 CTAs holds on an H100: the CTA with the most
# column blocks holds 2 C and 2 [U | g] blocks of [Bp][17] (f64, Bp <= 384),
# or 3 and 3 (f32, Bp <= 528)
CLUSTER_REACH = {torch.float64: 384, torch.float32: 528}
# the widths the plan is checked over, and past them, where the big kernel
# takes over (the issue's bounds of the cluster's reach, about 440 / 630)
CLUSTER_RANGE = {torch.float64: (81, 440), torch.float32: (98, 630)}


def _pr8_reach(elem):
    """The widest B the one-block big kernel of the port's first past-the-
    cluster build took: its pivot row and row j [2, 2B+1], three B-vectors,
    16 warps' candidates and int[B] in shared memory, the tile in a device
    workspace."""
    def need(b):
        return (-(-elem * (2 * (2 * b + 1) + 3 * b) // 16) * 16 + 12 * 16
                + -(-4 * b // 16) * 16)
    return max(b for b in range(1, 20000) if need(b) <= thomas.H100_SMEM_LIMIT)


def _check_big_plan(plan, s, b, elem):
    """The big kernel's plan for S systems of width B: R CTAs a system, one
    a panel and one more (at most the SMs), so that a CTA holds one C block
    and one [U | g] block (C block q and [U | g] block q on CTA q mod R);
    shared memory within the limit and equal to the source's count, the
    blocks there where they fit, the next stage prefetched where two tiles
    fit, else the blocks in a device workspace; every CTA of the launch
    co-resident (one an SM) and the systems past that looped over by
    groups."""
    r = plan["ctas"]
    bp, mc, mr = thomas.cluster_blocks(b, r)
    nq = bp // 16
    assert plan["kernel"] == "big" and plan["threads"] == 256
    assert (plan["padded"], plan["panels"], plan["c_blocks"],
            plan["rhs_blocks"]) == (bp, nq, mc, mr)
    assert r == min(nq + 1, thomas.H100_SM_COUNT)
    assert mc == -(-nq // r) and mr == nq // r + 1
    assert r < nq + 1 or mc == mr == 1
    tile = plan["tile_in_smem"]
    assert plan["smem_bytes"] == thomas.big_bytes(
        b, elem, r, plan["prefetch"], tile) <= thomas.H100_SMEM_LIMIT
    assert tile == (thomas.big_bytes(b, elem, r, False, True)
                    <= thomas.H100_SMEM_LIMIT)
    assert plan["prefetch"] == (tile and thomas.big_bytes(
        b, elem, r, True, True) <= thomas.H100_SMEM_LIMIT)
    assert plan["co_resident"] == thomas.H100_SM_COUNT
    assert plan["groups"] == min(s, thomas.H100_SM_COUNT // r)
    assert plan["blocks"] == plan["groups"] * r <= thomas.H100_SM_COUNT


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("equilibrate", [False, True], ids=["plain", "eq"])
def test_cluster_plan_over_its_range(dtype, equilibrate):
    """Every width past the wide classes up to the cluster's reach is the
    cluster kernel's: a power of two of CTAs (2-16), at most two panels
    a CTA where 16 CTAs allow it, at most 6 column blocks a CTA, the
    shared memory its layout needs within the limit (with the next stage
    prefetched where two tiles fit); past the reach, the big kernel's: a
    grid of co-resident CTAs, its blocks in their shared memory."""
    elem = torch.empty((), dtype=dtype).element_size()
    lo, hi = CLUSTER_RANGE[dtype]
    reach = CLUSTER_REACH[dtype]
    for b in range(lo, hi + 1):
        plan = thomas.kernel_plan(3, 7, b, dtype, equilibrate)
        if plan["kernel"] == "wide":
            continue
        if b > reach:
            assert plan["kernel"] == "big", b
            _check_big_plan(plan, 3, b, elem)
            assert plan["tile_in_smem"]
            with pytest.raises(ValueError, match="past what a cluster"):
                thomas.kernel_plan(3, 7, b, dtype, equilibrate,
                                   kernel="cluster")
            continue
        r = plan["cluster"]
        bp, mc, mr = thomas.cluster_blocks(b, r)
        assert plan["kernel"] == "cluster", b
        assert r in (2, 4, 8, 16) and plan["blocks"] == 3 * r
        assert plan["threads"] == thomas.CLUSTER_THREADS
        assert (plan["padded"], plan["c_blocks"], plan["rhs_blocks"]) == (
            bp, mc, mr)
        assert bp % 16 == 0 and b <= bp < b + 16
        assert plan["panels"] == bp // 16 and mc + mr <= 6
        assert mc <= 2 or r == 16
        assert plan["smem_bytes"] == thomas.cluster_bytes(
            b, elem, r, plan["prefetch"]) <= thomas.H100_SMEM_LIMIT
        assert plan["prefetch"] == (thomas.cluster_bytes(b, elem, r, True)
                                    <= thomas.H100_SMEM_LIMIT)
    assert thomas.kernel_plan(1, 7, reach, dtype, equilibrate)[
        "kernel"] == "cluster"


def test_cluster_plan_at_the_path_widths():
    """The 4-vehicle centralized width 108 (4 CTAs, the next stage
    prefetched), the synthetic 264 and the 8-vehicle edge 320 (16 CTAs, one
    tile); the layout's bytes by hand: [1 or 2 tiles][4 blocks][Bp][17],
    the pivot-row values [4][16][17], [2][Bp], the multipliers [32][17],
    then int[Bp], the factor warps' candidates (96 bytes) and a panel's
    rows (272 bytes)."""
    p108 = thomas.kernel_plan(1, 14, 108, torch.float64)
    assert (p108["kernel"], p108["cluster"], p108["prefetch"]) == (
        "cluster", 4, True)
    assert p108["smem_bytes"] == 8 * (2 * 4 * 112 * 17 + 4 * 16 * 17
                                      + 2 * 112 + 32 * 17) + 4 * 112 + 368
    p320 = thomas.kernel_plan(1, 7, 320, torch.float64)
    assert (p320["cluster"], p320["prefetch"], p320["blocks"]) == (
        16, False, 16)
    assert p320["smem_bytes"] == 8 * (4 * 320 * 17 + 4 * 16 * 17
                                      + 2 * 320 + 32 * 17) + 4 * 320 + 368
    assert thomas.kernel_plan(2, 7, 264, torch.float32, True)[
        "cluster"] == 16
    # forced onto the wide kernel's path widths, for comparison
    assert thomas.kernel_plan(1, 14, 66, torch.float64, kernel="cluster")[
        "cluster"] == 4
    assert thomas.kernel_plan(1, 7, 80, torch.float64, kernel="cluster")[
        "cluster"] == 4


def test_past_the_cluster_the_big_kernel_and_then_refusal():
    """One past the cluster's reach the big kernel takes the width, its
    blocks in the shared memory of 26 CTAs; the 9-vehicle edge (405 f64):
    27 CTAs of one C and one [U | g] block, one tile; the 11-vehicle edge
    (605 f32 equilibrated): 39 CTAs, two tiles (the next stage
    prefetched); the layout's bytes by hand: [1 or 2 tiles][2 blocks][Bp]
    [17], the pivot-row values [2][16][17], [2][Bp], the multipliers
    [32][17], then the factor warps' candidates (96 bytes), a panel's rows
    (272) and the factored panel's pivot rows (64). Past 768 (f64) the
    blocks leave shared memory for the device
    workspace; every width the one-block kernel before this one took is
    still taken (S = 3: 3 groups where they are co-resident, fewer groups
    looping over the systems where not), and the plan refuses only where
    what stays in shared memory passes the limit, or where the device
    cannot hold a system's CTAs at once."""
    plan = thomas.kernel_plan(1, 7, CLUSTER_REACH[torch.float64] + 1,
                              torch.float64)
    assert plan["kernel"] == "big" and plan["tile_in_smem"]
    assert plan["ctas"] == 26
    p405 = thomas.kernel_plan(1, 7, 405, torch.float64)
    assert (p405["kernel"], p405["ctas"], p405["c_blocks"],
            p405["rhs_blocks"], p405["prefetch"], p405["tile_in_smem"]) == (
        "big", 27, 1, 1, False, True)
    assert p405["smem_bytes"] == 8 * (2 * 416 * 17 + 2 * 16 * 17 + 2 * 416
                                      + 32 * 17) + 96 + 272 + 64 == 128944
    p605 = thomas.kernel_plan(1, 7, 605, torch.float32, True)
    assert (p605["kernel"], p605["ctas"], p605["c_blocks"],
            p605["rhs_blocks"], p605["prefetch"]) == ("big", 39, 1, 1, True)
    assert p605["smem_bytes"] == 4 * (2 * 2 * 608 * 17 + 2 * 16 * 17
                                      + 2 * 608 + 32 * 17) + 432 == 175024
    # the 9-vehicle edge of 3 and of 9 systems: 81 CTAs at once, then 4
    # groups of 27 (108 of the 132 SMs) looping over the 9
    assert thomas.kernel_plan(3, 7, 405, torch.float64)["groups"] == 3
    p9 = thomas.kernel_plan(9, 7, 405, torch.float64)
    assert (p9["groups"], p9["blocks"]) == (4, 108)
    for dtype, elem, first_ws in ((torch.float64, 8, 769),
                                  (torch.float32, 4, 1569)):
        assert thomas.kernel_plan(1, 7, first_ws - 1, dtype)["tile_in_smem"]
        ws = thomas.kernel_plan(3, 7, first_ws, dtype)
        _check_big_plan(ws, 3, first_ws, elem)
        assert not ws["tile_in_smem"] and ws["ctas"] == -(-first_ws // 16) + 1
        # the reach does not shrink: the widest width the one-block kernel
        # took, and 4000, which it refused in float64
        for b in (_pr8_reach(elem), 4000):
            _check_big_plan(thomas.kernel_plan(3, 1, b, dtype), 3, b, elem)
    assert _pr8_reach(8) < 4000
    # past the reach: what stays in shared memory passes the limit
    with pytest.raises(ValueError, match="shared memory"):
        thomas.kernel_plan(1, 1, 13000, torch.float64)
    # a device that holds fewer CTAs at once than a system needs
    with pytest.raises(ValueError, match="co-resident"):
        thomas.kernel_plan(1, 7, 405, torch.float64, co_resident=26)
    assert thomas.kernel_plan(1, 7, 405, torch.float64,
                              co_resident=264)["groups"] == 1
    assert thomas.kernel_plan(9, 7, 405, torch.float64,
                              co_resident=264)["groups"] == 9


def _panel_gauss_jordan(c, m, owners=1, workspace=(), seed=0):
    """``C^-1 [U | g]`` the way the cluster and big kernels order the work
    (numpy): the tile padded to Bp, a multiple of 16 (identity in C, zeros
    in M), U in M blocks 0 .. Bp/16 - 1 and g alone in block Bp/16, and
    cut into column blocks of 16: C block q and M block q held by owner
    q mod ``owners`` in slot q // ``owners`` of its C or M slots, as many as
    ``thomas.cluster_blocks`` plans; the owners in ``workspace`` hold their
    slots in one array for all of them, the big kernel's device workspace
    (where a block is held changes no arithmetic: the slots are checked).
    Each owner runs as a coroutine, resumed in an order drawn from
    ``seed`` among those not waiting, and reads another owner's panel only
    from what that owner published behind the panel's flag. The owner of a
    panel factors it in place (pivot: the first largest |entry| in rows
    i >= j of the column as updated so far, a NaN above all; floored at
    +-1e-30; only the panel's live columns swapped and updated, so column t
    keeps step t's multipliers, and 1 / pivot at the pivot row) and
    publishes a copy and its pivot rows. Each owner then updates its live
    blocks right of the panel late, from the published copy: the rows the
    swaps touch (J and the pivot rows below it) step by step, swaps
    included, keeping each step's pivot-row values, and every other row by
    its 16 multiply-subtracts in order; the owner of the next panel first
    updates that block, factors and publishes it (one panel of look-ahead).
    Returns the solution and the pivot rows."""
    nb = thomas.CLUSTER_NB
    b = c.shape[0]
    assert m.shape == (b, b + 1)
    bp, mc, mr = thomas.cluster_blocks(b, owners)
    nq = bp // nb
    tile = np.zeros((bp, 2 * bp + nb))
    tile[:, :bp] = np.eye(bp)
    tile[:b, :b] = c
    tile[:b, bp:bp + b] = m[:, :b]
    tile[:b, 2 * bp] = m[:, b]
    # block q < nq is C block q, else M block q - nq; each owner's slots,
    # C then M, in its own array or in the workspace's
    held = [np.full((mc + mr, bp, nb), np.nan) for _ in range(owners)]
    shared = np.full((len(workspace), mc + mr, bp, nb), np.nan)
    for o, k in zip(workspace, range(len(workspace))):
        held[o] = shared[k]

    def owner_slot(q):
        i = q if q < nq else q - nq
        return i % owners, (0 if q < nq else mc) + i // owners
    for q in range(nq + nq + 1):
        o, slot = owner_slot(q)
        assert slot < (mc if q < nq else mc + mr)
        assert np.isnan(held[o][slot]).all()        # one block a slot
        held[o][slot] = tile[:, q * nb:(q + 1) * nb]
    published = {}                   # panel -> (multipliers, pivot rows)

    def factor(p):
        o, slot = owner_slot(p)
        pan, j0, pv = held[o][slot], p * nb, []
        for t in range(nb):
            j = j0 + t
            col = pan[j:, t]
            nan = np.flatnonzero(np.isnan(col))
            piv_row = j + (nan[0] if len(nan) else int(np.argmax(
                np.abs(col))))
            pv.append(piv_row)
            pan[[j, piv_row], t:] = pan[[piv_row, j], t:]
            prow = pan[j, t:].copy()
            piv = prow[0]
            if not abs(piv) > thomas.PIVOT_FLOOR:
                piv = thomas.PIVOT_FLOOR if piv >= 0 else -thomas.PIVOT_FLOOR
            inv = 1.0 / piv
            mult = pan[:, t] * inv
            pan[:, t + 1:] = pan[:, t + 1:] - mult[:, None] * prow[None, 1:]
            pan[:, t] = mult
            pan[j, t + 1:] = prow[1:] * inv
            pan[j, t] = inv
        published[p] = (pan.copy(), pv)

    def update(p, q):
        """Block q updated late by the published panel p."""
        o, slot = owner_slot(q)
        trail = held[o][slot]
        pub, pv = published[p]
        j0 = p * nb
        touched = list(range(j0, j0 + nb)) + sorted(
            {r for r in pv if r >= j0 + nb})
        rest = np.setdiff1d(np.arange(bp), touched)
        prows = np.zeros((nb, nb))
        for t in range(nb):
            j = j0 + t
            trail[[j, pv[t]]] = trail[[pv[t], j]]
            prows[t] = trail[j]
            others = [r for r in touched if r != j]
            trail[others] = (trail[others] - pub[others, t][:, None]
                             * prows[t][None, :])
            trail[j] = prows[t] * pub[j, t]
        a = trail[rest]
        for t in range(nb):
            a = a - pub[rest, t][:, None] * prows[t][None, :]
        trail[rest] = a

    def run(o):
        """One owner; yields the panel it waits for, or None."""
        mine = [q for q in range(2 * nq + 1) if owner_slot(q)[0] == o]
        if o == 0:
            factor(0)
        for p in range(nq):
            while p not in published:
                yield p
            live = [q for q in mine if q > p]
            if p + 1 < nq and owner_slot(p + 1)[0] == o:
                update(p, p + 1)
                factor(p + 1)
                live.remove(p + 1)
            for q in live:
                update(p, q)
                yield None

    rng = random.Random(seed)
    running = {o: run(o) for o in range(owners)}
    waits = dict.fromkeys(running)
    while running:
        ready = [o for o in running if waits[o] is None
                 or waits[o] in published]
        assert ready, "every owner waits for a panel nobody publishes"
        o = rng.choice(ready)
        try:
            waits[o] = next(running[o])
        except StopIteration:
            del running[o]
    sol = np.concatenate([held[o][slot] for o, slot in map(
        owner_slot, range(nq, 2 * nq + 1))], axis=1)
    pivots = [r for p in range(nq) for r in published[p][1]]
    return np.concatenate([sol[:b, :b], sol[:b, bp:bp + 1]], axis=1), \
        pivots[:b]


@pytest.mark.parametrize("case", ["random-5", "random-40", "random-50",
                                  "ties", "nan", "random-300"])
def test_panel_order_matches_gauss_jordan(case):
    """The cluster and big kernels' order of work gives the plain
    elimination's pivot rows and its numbers, bit for bit (each entry takes
    the same multiplies and subtracts in the same order, only late, by the
    owner of its column block, from the published panel, whatever order the
    owners run in between the panels' flags): on random systems (one panel,
    a ragged second panel, four panels) over 3 owners, the second's blocks
    in a workspace, and on the exact ties and the NaN of
    ``test_plain_pivot_order_follows_the_kernels_rule``, whose NaN row is
    the first pivot, floored to -1e-30, so that every later step rounds
    multipliers near 1e30: an order of summation of its own would part
    from the plain version's pivots there; and at 300 wide (19 panels)
    over 20 owners, more than a cluster holds (the big kernel's plan at 300
    is 20 CTAs), a third of them with their blocks in a workspace."""
    rng = np.random.default_rng(12)
    owners, workspace = 3, (1,)
    if case == "random-300":
        owners, workspace = 20, tuple(range(0, 20, 3))
    if case.startswith("random"):
        b = int(case.split("-")[1])
        c = rng.normal(size=(b, b))
    else:
        b = 40
        cs = rng.integers(-2, 3, size=(2, b, b)).astype(np.float64)
        cs[:, :, 0] = 1.0
        cs[:, 5:9, 1] = 7.0
        cs[1, 6, 0] = np.nan
        c = cs[1] if case == "nan" else cs[0]
    m = np.random.default_rng(3).normal(size=(b, b + 1))
    pivots = []
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)    # 10x faster here on these small tensors
    try:
        want = thomas._gauss_jordan(torch.as_tensor(c)[None],
                                    torch.as_tensor(m)[None],
                                    pivots)[0].numpy()
    finally:
        torch.set_num_threads(n_threads)
    got, got_piv = _panel_gauss_jordan(c, m, owners=owners,
                                       workspace=workspace, seed=b)
    assert got_piv == [int(p[0]) for p in pivots]
    if case in ("ties", "nan"):
        assert got_piv[0] == (6 if case == "nan" else 0)
    np.testing.assert_array_equal(got, want)
