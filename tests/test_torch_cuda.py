"""The block-Thomas CUDA kernels against their plain PyTorch version, on a
card: the warp kernel (B <= 32), the wide kernel (above, up to its width
classes, and forced onto the narrow shapes), the cluster kernel (past the
wide classes: the 4-vehicle centralized width 108, a synthetic 264, the
8-vehicle consensus edge width 320 and the widths where its cluster and
block counts change) and the big kernel (past the cluster's reach: the
9-vehicle edge 405, the 11-vehicle edge 605, a ragged 401, three systems
at 405, its blocks in the device workspace at 800 and 1600; forced onto
108 and 264, and onto 320, where it gives the cluster kernel's bits; a
solve captured in a CUDA graph and replayed), plain and equilibrated, at
7 and at 14 stages;
and the planners that run them, graphed on the card against the CPU, and a
checkpointed run resumed on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances (relative to the solution's scale): 1e-10 in float64, 1e-4 in
float32 — both sides run the same recursion with the same pivot choice,
pivot floor, scaling and refinement; only the order of summation inside each
product differs.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (SHAPES, T14_SHAPES, VARIANTS, WIDE_SHAPES,
                        backward_error, flagship_profile, make_system)
from dlp_admm_torch.config import ObcaConfig, SolverConfig
from dlp_admm_torch.models.obca import ConsensusObcaPlanner
from dlp_admm_torch.solvers import ip_staged, thomas

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _system(seed, shape, kind, dtype, dev):
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in make_system(np.random.default_rng(seed), *shape,
                                      kind))


def _shape_id(s):
    return "x".join(map(str, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind,equilibrate", VARIANTS,
                         ids=[f"{k}{'-eq' if e else ''}" for k, e in VARIANTS])
@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES + ((3, 5, 26),),
                         ids=_shape_id)
def test_kernel_matches_plain(cuda, shape, kind, equilibrate, dtype):
    d, u, r = _system(5, shape, kind, dtype, cuda)
    # past the equilibrated variant's widths (float64 80) the cluster kernel
    name = thomas.kernel_plan(*shape, dtype, equilibrate)["kernel"]
    assert name == ("warp" if shape[2] <= 32 else "wide" if not (
        equilibrate and dtype == torch.float64 and shape[2] > 80)
        else "cluster")
    before = thomas.launches_by_kernel[name]
    total = thomas.launches
    got = thomas.block_thomas_solve(d, u, r, equilibrate)
    assert thomas.launches_by_kernel[name] == before + 1
    assert thomas.launches == total + 1
    want = thomas.block_thomas_plain(d, u, r, equilibrate)
    torch.cuda.synchronize()
    assert got.shape == r.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind,equilibrate", VARIANTS,
                         ids=[f"{k}{'-eq' if e else ''}" for k, e in VARIANTS])
@pytest.mark.parametrize("shape", T14_SHAPES, ids=_shape_id)
def test_kernel_matches_plain_at_fourteen_stages(cuda, shape, kind,
                                                 equilibrate, dtype):
    """The centralized planner's recursion length, T = 14: the warp
    kernel's 32-wide build keeps 14 stages of X_k | y_k in shared memory,
    the wide kernel back-substitutes over 14 stages."""
    d, u, r = _system(9, shape, kind, dtype, cuda)
    name = thomas.kernel_plan(*shape, dtype, equilibrate)["kernel"]
    before = thomas.launches_by_kernel[name]
    got = thomas.block_thomas_solve(d, u, r, equilibrate)
    assert thomas.launches_by_kernel[name] == before + 1
    want = thomas.block_thomas_plain(d, u, r, equilibrate)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_centralized_four_vehicle_width_is_refused(cuda, dtype):
    """The 4-vehicle centralized KKT blocks (108 wide), past the wide
    kernel's range in the variant the staged solver asks for, are no longer
    refused: the cluster kernel solves them (one launch, equal to the plain
    version)."""
    d, u, r = _system(9, (1, 14, 108), "kkt_saddle", dtype, cuda)
    eq = dtype != torch.float64
    before = thomas.launches_by_kernel["cluster"]
    got = thomas.block_thomas_solve(d, u, r, eq)
    assert thomas.launches_by_kernel["cluster"] == before + 1
    want = thomas.block_thomas_plain(d, u, r, eq)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind,equilibrate", VARIANTS,
                         ids=[f"{k}{'-eq' if e else ''}" for k, e in VARIANTS])
@pytest.mark.parametrize("shape", ((1, 14, 108), (2, 7, 264), (1, 7, 405),
                                   (1, 7, 401), (3, 7, 405), (1, 7, 605)),
                         ids=_shape_id)
def test_big_kernel_matches_plain(cuda, shape, kind, equilibrate, dtype):
    """The big kernel at the 9-vehicle edge width 405 (27 CTAs), a ragged
    401, three systems at 405 (81 CTAs at once) and the 11-vehicle edge
    width 605 (39 CTAs, the next stage prefetched in float32), and forced
    onto the
    shapes the cluster kernel solves (108, 264, and in float32 405),
    float32 unequilibrated at 108, which the wide kernel holds."""
    d, u, r = _system(11, shape, kind, dtype, cuda)
    plan = thomas.kernel_plan(*shape, dtype, equilibrate)["kernel"]
    if thomas.cluster_size(shape[2], d.element_size()) is None:
        assert plan == "big"
    else:
        assert plan == ("wide" if dtype == torch.float32 and not equilibrate
                        and shape[2] <= 138 else "cluster")
    before = thomas.launches_by_kernel["big"]
    got = thomas.launch_kernel(d, u, r, equilibrate, kernel="big")
    assert thomas.launches_by_kernel["big"] == before + 1
    want = thomas.block_thomas_plain(d, u, r, equilibrate)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_big_kernel_gives_the_cluster_kernels_bits(cuda, dtype):
    """Forced onto the 8-vehicle edge width 320 (21 CTAs publishing their
    panels through L2, against the cluster kernel's 16 through distributed
    shared memory) the big kernel takes every entry's operations in the
    same order, so it gives the cluster kernel's bits."""
    eq = dtype == torch.float32
    d, u, r = _system(13, (2, 7, 320), "kkt_saddle", dtype, cuda)
    big = thomas.launch_kernel(d, u, r, eq, kernel="big")
    cluster = thomas.launch_kernel(d, u, r, eq, kernel="cluster")
    torch.cuda.synchronize()
    assert torch.equal(big, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,equilibrate",
                         (((1, 2, 800), torch.float64, False),
                          ((2, 2, 1600), torch.float32, True)),
                         ids=["800-f64", "1600-f32-eq"])
def test_big_kernel_workspace_matches_plain(cuda, shape, dtype, equilibrate):
    """Past the widths whose blocks a CTA's shared memory holds (768 in
    float64, 1568 in float32) the big kernel keeps them in a device
    workspace, one CTA a panel and one more, with the same order of
    work."""
    d, u, r = _system(17, shape, "kkt_saddle", dtype, cuda)
    plan = thomas.kernel_plan(*shape, dtype, equilibrate)
    assert plan["kernel"] == "big" and not plan["tile_in_smem"]
    got = thomas.block_thomas_solve(d, u, r, equilibrate)
    want = thomas.block_thomas_plain(d, u, r, equilibrate)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
def test_big_kernel_replays_a_captured_solve_bit_for_bit(cuda):
    """One solve at the 9-vehicle edge width, captured in a CUDA graph
    (its flags zeroed by a memset captured with it) and replayed three
    times: the eager call's bits each time, one launch counted a replay."""
    d, u, r = _system(19, (1, 7, 405), "kkt_saddle", torch.float64, cuda)
    want = thomas.launch_kernel(d, u, r)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    captured = thomas.captured["big"]
    with torch.cuda.stream(stream):
        graph.capture_begin()
        got = thomas.launch_kernel(d, u, r)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    assert thomas.captured["big"] == captured + 1
    for _ in range(3):
        got.fill_(float("nan"))
        before = thomas.launches_by_kernel["big"]
        thomas.replay(graph, {"big": 1})
        torch.cuda.synchronize()
        assert thomas.launches_by_kernel["big"] == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_big_layout_mirrors_the_source(cuda):
    """The wrapper's count of the big kernel's shared memory and sync
    workspace equals the compiled source's, plan by plan, and the card
    holds every CTA of the 9-vehicle edge's plan at once."""
    for dtype, elem in ((torch.float64, 8), (torch.float32, 4)):
        lib = thomas._lib(thomas.library_name("big", dtype))
        for b in (108, 264, 320, 385, 401, 405, 529, 605, 769, 800, 1569,
                  1600, 4000):
            r, prefetch, tile = thomas.big_ctas(b, elem)
            assert lib.block_thomas_big_smem_bytes(
                b, r, int(prefetch), int(tile)) == thomas.big_bytes(
                    b, elem, r, prefetch, tile), (b, dtype)
            assert lib.block_thomas_big_sync_ints(b) == \
                thomas.big_sync_ints(b)
    n = thomas.big_co_resident(405, torch.float64, False)
    assert n >= thomas.kernel_plan(1, 7, 405, torch.float64)["ctas"]


# the cluster kernel's widths where its cluster size, its blocks a CTA or
# its prefetch change: 98-119 (4 CTAs, prefetched), 169 (8, prefetched),
# 200 (8, one tile), 264 and 320 (16, one tile; float32 prefetched)
CLUSTER_WIDTHS = (98, 108, 119, 169, 200, 264, 320)
# per variant: the path's kinds, exact ties of small integers and a NaN
CLUSTER_FAMILIES = {False: ("kkt_saddle", "zero_lead", "ties", "nan"),
                    True: ("kkt_saddle", "badly_scaled", "ties", "nan")}


def _family(seed, shape, kind, dtype, dev):
    """``make_system``'s kinds, or ``ties``: blocks of small integers whose
    first column is all ones and whose second has a tie below the top, as
    ``tests/test_torch_thomas.py``'s pivot-order test, coupled by 0.1 times
    small integers; ``nan``: the same with one NaN in the first system's
    first stage, the first pivot column of the second system."""
    if kind not in ("ties", "nan"):
        return _system(seed, shape, kind, dtype, dev)
    s, t, b = shape
    rng = np.random.default_rng(seed)
    diag = rng.integers(-2, 3, size=(s, t, b, b)).astype(np.float64)
    diag[..., :, 0] = 1.0
    diag[..., 5:9, 1] = 7.0
    upper = 0.1 * rng.integers(-2, 3, size=(s, t, b, b))
    if kind == "nan":
        diag[s - 1, 0, 6, 0] = np.nan
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in (diag, upper, rng.normal(size=(s, t, b))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("equilibrate", [False, True], ids=["plain", "eq"])
@pytest.mark.parametrize("family", range(4))
@pytest.mark.parametrize("b", CLUSTER_WIDTHS)
def test_cluster_kernel_matches_plain(cuda, b, family, equilibrate, dtype):
    """The cluster kernel forced at every width where its layout changes,
    two systems of 3 stages: the same numbers as the plain version (TOL).
    In the NaN family the second system's first pivot is the NaN, which
    both floor to -1e-30, so every later step of that system rounds values
    scaled by 1e30: there the two are held to the same pattern of finite
    entries (none equilibrated, where the NaN spreads through its row
    scale; all of them unequilibrated), and the first system, launched
    beside it, to the same numbers. The ties and NaN families' integer
    blocks are conditioned so that float32 rounding of the stage products
    (summed in another order than the plain version's matmul) moves their
    solutions by up to 3.7e-4 of their scale at 200-320 wide (an H100,
    one earlier build of this kernel): in float32 they are held to the
    plain version's row-wise backward error instead (no more than 4 times
    it, or 10 units of rounding), the measure phase 7 of chip_smoke.py
    holds the planner's ill-conditioned blocks to."""
    kind = CLUSTER_FAMILIES[equilibrate][family]
    shape = (2, 3, b)
    d, u, r = _family(13 + b, shape, kind, dtype, cuda)
    before = dict(thomas.launches_by_kernel)
    got = thomas.launch_kernel(d, u, r, equilibrate, kernel="cluster")
    assert thomas.launches_by_kernel == dict(
        before, cluster=before["cluster"] + 1)
    want = thomas.block_thomas_plain(d, u, r, equilibrate)
    torch.cuda.synchronize()
    if kind == "nan":
        finite = torch.isfinite(want[1])
        assert bool(finite.all()) != equilibrate
        assert torch.equal(torch.isfinite(got[1]), finite)
        got, want, d, u, r = (x[:1] for x in (got, want, d, u, r))
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32 and kind in ("ties", "nan"):
        got_be = backward_error(d, u, r, got)[1]
        want_be = backward_error(d, u, r, want)[1]
        assert got_be <= max(4 * want_be,
                             10 * torch.finfo(dtype).eps), (got_be, want_be)
        return
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cluster_profiling_build_and_graph_replay(cuda, dtype):
    """The profiling build gives the same bits and [S, R, 6] clocks; a
    launch captured in a CUDA graph counts as captured, runs when
    replayed and gives the eager launch's bits."""
    eq = dtype == torch.float32
    d, u, r = _system(9, (2, 14, 108), "kkt_saddle", dtype, cuda)
    want = thomas.launch_kernel(d, u, r, eq)
    got, clocks = thomas.launch_kernel(d, u, r, eq, profile=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    r_ = thomas.kernel_plan(2, 14, 108, dtype, eq)["cluster"]
    assert clocks.shape == (2, r_, 6) and bool((clocks[:, 0, 0] > 0).all())
    assert bool((clocks[:, 0, 5] > 0).all())       # back substitution
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    captured = thomas.captured["cluster"]
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = thomas.launch_kernel(d, u, r, eq)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    assert thomas.captured["cluster"] == captured + 1
    before = thomas.launches_by_kernel["cluster"]
    thomas.replay(graph, {"cluster": 1})
    torch.cuda.synchronize()
    assert thomas.launches_by_kernel["cluster"] == before + 1
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_consensus_resume_on_the_card_is_bit_equal(cuda, tmp_path):
    """The flagship's float64 profile (ADMM cap 5): 2 steps with a
    checkpoint, resumed to step 4 by a new planner on the card, give the
    bits of the uninterrupted 4 steps; the resumed steps' K1 launches equal
    their block solves, and the carry stays on the card."""
    prof = flagship_profile(torch.float64, max_admm_iters=5)
    path = str(tmp_path / "run.npz")
    full_st, full_its, _, _ = ConsensusObcaPlanner(
        **prof, device=cuda).run(n_steps=4)
    ConsensusObcaPlanner(**prof, device=cuda).run(n_steps=2,
                                                  checkpoint_path=path)
    pl = ConsensusObcaPlanner(**prof, device=cuda)
    total = thomas.launches
    tail_st, tail_its, _, _ = pl.run(n_steps=4, checkpoint_path=path,
                                     resume=True)
    torch.cuda.synchronize()
    assert thomas.launches - total == pl.block_solves > 0
    assert np.array_equal(tail_st, full_st[2:])
    assert np.array_equal(tail_its, full_its[2:])
    assert pl.carry[0].device.type == "cuda"


@pytest.mark.cuda
def test_centralized_solve_on_the_card_matches_cpu(cuda):
    """One centralized ``solve_at`` (2 vehicles, horizon 15: K1 at
    (1, 14, 34), the IP trip a replayed CUDA graph) on the card equals the
    same solve on the CPU (1e-9, equal trips), and a second call on the card
    gives the same bits."""
    from dlp_admm_torch.models.obca import CentralizedObcaPlanner

    def solve(device):
        pl = CentralizedObcaPlanner(ObcaConfig(horizon=15, min_dis=1.0),
                                    device=device)
        return pl, pl.solve_at(pl.refs[:, 0, :], 3)

    thomas.reset_counts()
    pl, (xs, us, lam, sol) = solve(cuda)
    torch.cuda.synchronize()
    assert thomas.launches == pl.block_solves > 0
    assert thomas.launches_by_kernel["wide"] == thomas.launches
    _, (xs2, _, _, sol2) = solve(cuda)
    assert torch.equal(sol.x, sol2.x) and torch.equal(xs, xs2)
    _, (_, _, _, want) = solve("cpu")
    assert int(sol.iterations) == int(want.iterations)
    assert bool(sol.converged) and bool(want.converged)
    torch.testing.assert_close(sol.x.cpu(), want.x, rtol=0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind,equilibrate", VARIANTS,
                         ids=[f"{k}{'-eq' if e else ''}" for k, e in VARIANTS])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=_shape_id)
def test_wide_kernel_on_narrow_shapes(cuda, shape, kind, equilibrate, dtype):
    """The block-per-system kernel holds any width up to its shared-memory
    limit; forced onto the flagship's widths it agrees with the plain
    version as the warp kernel does."""
    d, u, r = _system(8, shape, kind, dtype, cuda)
    before = dict(thomas.launches_by_kernel)
    got = thomas.launch_kernel(d, u, r, equilibrate, kernel="wide")
    assert thomas.launches_by_kernel == dict(before, wide=before["wide"] + 1)
    want = thomas.block_thomas_plain(d, u, r, equilibrate)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_profiling_build_gives_the_same_numbers(cuda, dtype):
    eq = dtype == torch.float32
    d, u, r = _system(9, (2, 7, 19), "kkt_saddle", dtype, cuda)
    got, clocks = thomas.launch_kernel(d, u, r, eq, profile=True)
    want = thomas.launch_kernel(d, u, r, eq)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert clocks.shape == (2, 6) and bool((clocks.sum(1) > 0).all())
    assert bool((clocks[:, 1] > 0).all()) == eq      # equilibration phase
    with pytest.raises(ValueError, match="profiling kernel"):
        thomas.launch_kernel(d, u, r, not eq, profile=True)


@pytest.mark.cuda
def test_long_chain_keeps_its_history_in_scratch(cuda):
    """T * B past the shared memory a warp may use: X_k | y_k go through
    global scratch, with the same numbers."""
    shape = (2, 400, 32)
    assert not thomas.kernel_plan(*shape, torch.float64)["hist_in_smem"]
    d, u, r = _system(10, shape, "diag_dominant", torch.float64, cuda)
    got = thomas.block_thomas_solve(d, u, r)
    want = thomas.block_thomas_plain(d, u, r)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[torch.float64], rel


@pytest.mark.cuda
@pytest.mark.parametrize("equilibrate", [False, True])
def test_singular_block_is_not_finite_garbage(cuda, equilibrate):
    """A block with a zero row and column: the floored pivot gives values
    of the order of 1e30 or non-finite ones, which the staged solver's guard
    and solve verification reject."""
    d, u, r = _system(11, (2, 1, 19), "kkt_saddle", torch.float64, cuda)
    d[0, 0, 4, :] = 0.0
    d[0, 0, :, 4] = 0.0
    got = thomas.block_thomas_solve(d, u, r, equilibrate)
    torch.cuda.synchronize()
    assert not bool((got[0].abs() < 1e20).all())
    assert bool(torch.isfinite(got[1]).all())         # the other system


@pytest.mark.cuda
def test_kernel_ignores_last_upper_block(cuda):
    d, u, r = _system(6, (3, 5, 6), "diag_dominant", torch.float64, cuda)
    full = thomas.block_thomas_solve(d, u, r)
    short = thomas.block_thomas_solve(d, u[:, :-1].contiguous(), r)
    torch.cuda.synchronize()
    torch.testing.assert_close(full, short, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_pivot_floor(cuda):
    z = torch.zeros(1, 2, 3, 3, dtype=torch.float64, device=cuda)
    r = torch.ones(1, 2, 3, dtype=torch.float64, device=cuda)
    got = thomas.block_thomas_solve(z, z, r)
    torch.testing.assert_close(got, thomas.block_thomas_plain(z, z, r))
    got = thomas.block_thomas_solve(z, z, r, equilibrate=True)
    torch.testing.assert_close(got, thomas.block_thomas_plain(z, z, r, True))


def _tracking_nlp():
    """A small staged tracking NLP (dynamics links, control bounds)."""
    a_dyn = torch.tensor([[1.0, 0.1], [0.0, 1.0]], dtype=torch.float64)
    b_dyn = torch.tensor([[0.005], [0.1]], dtype=torch.float64)

    def f_stage(w, p):
        return torch.sum((w[:2] - p["ref"]) ** 2) + 0.1 * torch.sum(w[2:] ** 2)

    def ce_link(w_prev, w, p):
        x_prev = torch.where(p["first"] > 0, p["init"], w_prev[:2])
        return w[:2] - (p["a"] @ x_prev + p["b"] @ w[2:])

    def ce_stage(w, p):
        return w[:0]

    def ci_stage(w, p):
        return torch.cat([0.8 + w[2:], 0.8 - w[2:]])

    s, t = 3, 6
    first = torch.zeros(s, t, dtype=torch.float64)
    first[:, 0] = 1.0
    ref = torch.stack([torch.linspace(0.8, -0.5, t, dtype=torch.float64),
                       torch.zeros(t, dtype=torch.float64)], -1)
    init = torch.tensor([[1.0, 0.0], [0.4, -0.3], [-0.6, 0.5]],
                        dtype=torch.float64)
    p = dict(first=first, ref=ref.expand(s, t, 2),
             init=init[:, None].expand(s, t, 2),
             a=a_dyn.expand(s, t, 2, 2), b=b_dyn.expand(s, t, 2, 1))
    return (ip_staged.StagedNLP(f_stage, ce_link, ce_stage, ci_stage),
            torch.zeros(s, t, 3, dtype=torch.float64), p)


@pytest.mark.cuda
def test_graphed_ip_loop_matches_eager_cpu(cuda):
    """On the card the IP loop replays a captured CUDA graph of one trip;
    it must give the eager CPU loop's iterates and count each replayed
    kernel launch."""
    snlp, w0, p = _tracking_nlp()
    cfg = SolverConfig(ip_iters=40, ip_tol=1e-8)
    want = ip_staged.solve_staged(snlp, w0, p, cfg)
    before = thomas.launches
    got = ip_staged.solve_staged(snlp, w0.to(cuda),
                                 {k: v.to(cuda) for k, v in p.items()}, cfg)
    torch.cuda.synchronize()
    assert thomas.launches - before == got.block_solves == want.block_solves
    assert got.block_solves > 4            # graph replays took part
    assert torch.equal(got.iterations.cpu(), want.iterations)
    assert bool(got.converged.all())
    for name in ("w", "y_link", "z", "s"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_graphed_ip_loop_float32(cuda):
    """The float32 solve on the card (equilibrated kernel, three launches a
    trip) against the eager CPU loop on the plain version: float32 rounding
    of two kinds through some ten trips that end at ``ip_tol=1e-4``."""
    snlp, w0, p = _tracking_nlp()
    w0, p = w0.float(), {k: v.float() for k, v in p.items()}
    cfg = SolverConfig(ip_iters=40, ip_tol=1e-4)
    want = ip_staged.solve_staged(snlp, w0, p, cfg)
    before = thomas.launches
    got = ip_staged.solve_staged(snlp, w0.to(cuda),
                                 {k: v.to(cuda) for k, v in p.items()}, cfg)
    torch.cuda.synchronize()
    assert got.w.dtype == torch.float32
    assert thomas.launches - before == got.block_solves
    assert got.block_solves == 3 * int(got.iterations.max())
    assert bool(got.converged.all()) and bool(want.converged.all())
    assert int((got.iterations.cpu() - want.iterations).abs().max()) <= 1
    for name in ("w", "y_link", "z", "s"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_planner_runs_on_the_card_by_default(cuda):
    pl = ConsensusObcaPlanner(ObcaConfig(horizon=8, max_admm_iters=1),
                              scfg=SolverConfig(ip_iters=40, ip_tol=1e-4),
                              dtype=torch.float32)
    assert pl.device.type == "cuda" and pl.refs.device.type == "cuda"
    states, its, _, _ = pl.run(n_steps=1)
    assert states.shape == (2, 2, 5) and np.all(np.isfinite(states))
    assert all(x.device.type == "cuda" and x.dtype == torch.float32
               for x in pl.carry[1])


@pytest.mark.cuda
def test_wrapper_checks_on_cuda(cuda):
    d, u, r = _system(7, (2, 4, 5), "diag_dominant", torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        thomas.block_thomas_solve(d.transpose(-1, -2), u, r)
    with pytest.raises(ValueError, match="one device"):
        thomas.block_thomas_solve(d, u, r.cpu())
    # 200 wide, past the wide kernel's shared memory, is the cluster
    # kernel's (8 CTAs); 13000 wide, whose row maxima and scales alone pass
    # a big-kernel CTA's shared-memory limit, is refused before anything
    # launches
    d, u, r = _system(7, (1, 2, 200), "diag_dominant", torch.float64, cuda)
    before = dict(thomas.launches_by_kernel)
    assert bool(torch.isfinite(thomas.block_thomas_solve(d, u, r)).all())
    assert thomas.launches_by_kernel == dict(
        before, cluster=before["cluster"] + 1)
    huge = 13000
    total = thomas.launches
    with pytest.raises(ValueError, match="shared memory"):
        thomas.block_thomas_solve(
            torch.zeros(1, 1, huge, huge, dtype=torch.float64, device=cuda),
            torch.zeros(1, 1, huge, huge, dtype=torch.float64, device=cuda),
            torch.zeros(1, 1, huge, dtype=torch.float64, device=cuda))
    assert thomas.launches == total


def _window_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "check_torch_window.py")
    spec = importlib.util.spec_from_file_location("check_torch_window", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_float32_run_repeats_bit_for_bit(cuda, tmp_path):
    """The float32 6-step slice of ``chip_smoke.py`` and conflict-window
    step 14 from the JAX run's carry
    (``tests/data/consensus_obca_f32_carry14.npz``), twice in this process
    and once in a fresh one (whose first call is the process's first graph
    capture): the carry after every IP trip and ADMM iteration, the final
    states and the ADMM iteration counts are the same, bit for bit.
    About 4 minutes on an H100."""
    tool = _window_tool()
    data = np.load(tool.STEP14_CARRY)
    calls = [[tool.one_call(job, data, "cuda") for job in ("slice", 14)]
             for _ in range(2)]
    out = tmp_path / "calls.json"
    subprocess.run([sys.executable, tool.__file__, "--repeat", "1",
                    "--slice", "--steps", "14", "--carries",
                    tool.STEP14_CARRY, "--json", str(out)], check=True,
                   timeout=900)
    fresh = json.loads(out.read_text())["calls"]
    for i, job in enumerate(("slice", "14")):
        first = calls[0][i]
        others = [calls[1][i], fresh[job][0]]
        for other in others:
            assert other["iterations"] == first["iterations"], job
            assert other["final_digest"] == first["final_digest"], job
            rows = [tuple(r) for r in other["rows"]]
            assert tool.first_parting(first["rows"], rows) is None, job


def _pi_admm_fused(device, dtype=torch.float64):
    """tests/test_pi_admm.py::TestFusedRunner's fused batch (4 vehicles,
    horizon 8, 2 lanes, 16 steps) on the port, on ``device``."""
    from dlp_admm_torch.config import (DualUpdateConfig, PiAdmmConfig,
                                       SolverConfig)
    from dlp_admm_torch.models.pi_admm import PiAdmmEngine
    from dlp_admm_torch.scenarios import pi_admm_overtake_refs
    cfg = PiAdmmConfig(num_veh=4, horizon=8, speeds=(8.0, 4.0, 8.0, 4.0),
                       dis_thres=3.5, iter_num=20, eps_pri=0.5, eps_dual=0.5,
                       stop_needs_clearance=False, eps_per_edge=True)
    refs, xt0 = pi_admm_overtake_refs(cfg)
    eng = PiAdmmEngine(cfg, DualUpdateConfig(windup_sat=200.0),
                       SolverConfig(qp_iters=16, qp_tol=1e-4, qp_segments=1,
                                    qp_ns_iters=10, qp_unroll=16),
                       layout="pairwise", refs=refs, n_sqp=1,
                       carry_admm_state=True, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    xts = xt0[None] + np.concatenate([0.4 * rng.normal(size=(2, 4, 2)),
                                      np.zeros((2, 4, 1))], axis=-1)
    return eng, xts, np.zeros((2, 4, 8))


@pytest.mark.cuda
def test_graphed_pi_admm_fused_batch_matches_cpu(cuda):
    """The fused PI-ADMM loop on the card (one eager trip, then replays of
    its CUDA graph) gives the CPU's records: equal iterations and flags,
    states within 1e-8; chunks of 1 and 8 trips give the same bits."""
    eng, xts, us = _pi_admm_fused(cuda)
    got = eng.run_fused_batch(xts, us, 16)
    trips = eng.fused_trips
    one = eng.run_fused_batch(xts, us, 16, chunk=1)
    one_trips = eng.fused_trips
    ceng, _, _ = _pi_admm_fused("cpu")
    want = ceng.run_fused_batch(xts, us, 16)
    for name, x in got._asdict().items():
        assert torch.equal(x, getattr(one, name)), name
        w = getattr(want, name)
        if x.dtype in (torch.bool, torch.int32):
            assert torch.equal(x.cpu(), w), name
        else:
            torch.testing.assert_close(x.cpu(), w, rtol=0, atol=1e-8,
                                       msg=name)
    longest = int(want.iterations.sum(dim=1).max())
    assert one_trips == longest and trips % 8 == 0 and trips >= longest


def _batch_planner(device, max_admm_iters=3):
    """The flagship's float64 profile at a small ADMM cap
    (``tests/test_torch_consensus_spmd.py``'s batch configuration)."""
    return ConsensusObcaPlanner(
        ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                   max_admm_iters=max_admm_iters),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-6), local_prox=700.0,
        prox_growth=1.5, device=device)


def _batch_starts():
    pl = _batch_planner("cpu")
    init0 = pl.refs[:, 0, :].numpy()
    inits = np.broadcast_to(init0, (3,) + init0.shape).copy()
    inits[1:, :, :2] += 0.3 * np.random.default_rng(1).normal(size=(2, 2, 2))
    return inits


@pytest.mark.cuda
def test_graphed_batch_step_matches_cpu(cuda):
    """The scenario-batched consensus step on the card (every staged solve
    a replayed CUDA graph of the IP trip, K1 on (6, 7, 19) and (3, 7, 20))
    equals the CPU's at 3 lanes over 2 MPC steps (1e-10, equal iterations
    and flags); the launches equal the block solves. Lane 0 is done after
    its first ADMM iteration while the others run to the cap of 3: its
    outputs are bit for bit those of the same step capped at 1 iteration,
    so its frozen carry kept its bits through the other lanes'
    iterations."""
    from dlp_admm_torch.interop import bar_state_from_numpy
    from dlp_admm_torch.parallel.consensus_spmd import (
        make_consensus_spmd_step, run_scenario_batch)
    inits = _batch_starts()
    pl = _batch_planner(cuda)
    thomas.reset_counts()
    got = run_scenario_batch(pl, inits, 2)
    torch.cuda.synchronize()
    assert thomas.launches == pl.block_solves > 0
    want = run_scenario_batch(_batch_planner("cpu"), inits, 2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[4], want[4])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    assert got[1][:, 0].tolist() == [1, 3, 3]
    # the frozen lane
    bs = _batch_planner(cuda).create_bar_state()
    bs_b = bar_state_from_numpy({k: np.stack([v.cpu().numpy()] * 3)
                                 for k, v in bs._asdict().items()},
                                device=cuda)
    st = torch.as_tensor(inits, device=cuda)
    out3 = make_consensus_spmd_step(_batch_planner(cuda, 3))(st, bs_b, 0)
    out1 = make_consensus_spmd_step(_batch_planner(cuda, 1))(st, bs_b, 0)
    assert out3[2].tolist() == [1, 3, 3] and out1[2].tolist() == [1, 1, 1]
    for a, b in zip(out3[:1] + tuple(out3[1]) + out3[2:],
                    out1[:1] + tuple(out1[1]) + out1[2:]):
        assert torch.equal(a[0], b[0])


# -- the bilevel, tightening and ALADIN planners (dense IP solves) ------------

def _no_k1_since(captured):
    """No block-Thomas launch since the counts were reset, and no capture
    since ``captured`` was read."""
    return (not any(thomas.launches_by_kernel.values())
            and dict(thomas.captured) == captured)


@pytest.mark.cuda
def test_fixed_dual_and_aladin_planners_default_to_the_card(cuda):
    from dlp_admm_torch.models.aladin import (AladinEngine, AladinProblem,
                                              AladinUnicyclePlanner)
    from dlp_admm_torch.models.bilevel import (BilevelObcaPlanner,
                                               TighteningObcaPlanner,
                                               TighteningSlackObcaPlanner)
    for cls in (BilevelObcaPlanner, TighteningObcaPlanner,
                TighteningSlackObcaPlanner):
        pl = cls()
        assert pl.device.type == "cuda" and pl.refs.device.type == "cuda"
    pl = AladinUnicyclePlanner()
    assert pl.device.type == "cuda" and pl.refs.device.type == "cuda"
    prob = AladinProblem(f=lambda y, p: torch.sum((y - p) ** 2),
                         h=lambda y, p: y[:0],
                         a_mats=torch.tensor([[[1.0]], [[-1.0]]]),
                         b=torch.zeros(1))
    eng = AladinEngine(prob)
    assert eng.device.type == "cuda"
    assert eng.problem.a_mats.device.type == "cuda"


def _bilevel_step(device):
    """One bilevel MPC step (3 rounds) from the planner's own start."""
    from dlp_admm_torch.models.bilevel import BilevelObcaPlanner
    pl = BilevelObcaPlanner(device=device)
    st, bs, info = pl._mpc_step(pl.refs[:, 0, :], pl.create_state(), 0)
    return [st] + list(bs), info


@pytest.mark.cuda
def test_bilevel_step_on_the_card_matches_cpu(cuda):
    """One bilevel step (its dense local and dual IP solves, torch.linalg
    on the card) equals the CPU's within 1e-10 with the same IP trips, a
    second call gives the same bits, and no block-Thomas kernel runs."""
    thomas.reset_counts()
    captured = dict(thomas.captured)
    got, info = _bilevel_step(cuda)
    again, info2 = _bilevel_step(cuda)
    torch.cuda.synchronize()
    assert _no_k1_since(captured)
    want, want_info = _bilevel_step("cpu")
    for a, b, c in zip(got, again, want):
        assert a.device.type == "cuda" and torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-10, atol=1e-10)
    assert info == info2
    assert (info["local_trips"], info["dual_trips"]) == (
        want_info["local_trips"], want_info["dual_trips"])


def _aladin_iteration(device):
    """One ALADIN iteration of the crossing planner at step 19, the
    conflict onset, from the JAX run's state there
    (``tests/data/aladin_ref.npz``) and a zero steering warm start."""
    from dlp_admm_torch.config import PiAdmmConfig
    from dlp_admm_torch.models.aladin import AladinUnicyclePlanner
    pl = AladinUnicyclePlanner(PiAdmmConfig(), scfg=SolverConfig(
        ip_iters=25, ip_tol=1e-7), device=device)
    ref = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "aladin_ref.npz"))
    xt = torch.as_tensor(ref["states"][19], device=pl.device)
    u = torch.zeros((pl.v, pl.h), dtype=torch.float64, device=pl.device)
    pos = pl._predict_own(u, xt, pl.spd).reshape(1, -1).expand(pl.v, -1)
    state = pl.engine.init_state(torch.cat([u, pos], dim=1))
    state, ys = pl.engine.step(state, pl._agent_params(xt, 19))
    return list(state) + [ys]


@pytest.mark.cuda
def test_aladin_iteration_on_the_card_matches_cpu(cuda):
    """One ALADIN iteration (the agents' batched IP solve, the per-agent
    derivatives, the coupled KKT solve and the line search) on the card
    repeats bit for bit, launches no block-Thomas kernel, and equals the
    CPU's: the iterate ``x``, the agents' solutions ``ys`` and the two
    residuals within 1e-10; the coupling multipliers ``lam`` within 1e-7.
    They come out of the coupled KKT solve alone, whose matrix has
    condition number 2.6e14 here (its -1e-9 multiplier block beside mu =
    1e4): on the CPU a 1e-16 relative change of that matrix moves the
    solution by up to 1.3e-10, and the card, whose inputs to it differ at
    the rounding level, moved ``lam`` by 2.6e-9 (of 18)."""
    thomas.reset_counts()
    captured = dict(thomas.captured)
    got = _aladin_iteration(cuda)
    again = _aladin_iteration(cuda)
    torch.cuda.synchronize()
    assert _no_k1_since(captured)
    want = _aladin_iteration("cpu")
    for name, a, b, c in zip(("x", "lam", "coupling_res", "step_norm",
                              "ys"), got, again, want):
        assert a.device.type == "cuda" and torch.equal(a, b)
        tol = 1e-7 if name == "lam" else 1e-10
        torch.testing.assert_close(a.cpu(), c, rtol=tol, atol=tol,
                                   msg=name)
