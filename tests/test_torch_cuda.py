"""The block-Thomas CUDA kernel against its plain PyTorch version, on a card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances (relative to the solution's scale): 1e-10 in float64, 1e-4 in
float32 — both sides run the same recursion with the same pivot choice and
pivot floor; only the order of summation inside each product differs.
"""
import numpy as np
import pytest
import torch

from chip_smoke import KINDS, SHAPES, make_system
from dlp_admm_torch.config import SolverConfig
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, kind, dtype):
    d, u, r = _system(5, shape, kind, dtype, cuda)
    before = thomas.launches
    got = thomas.block_thomas_solve(d, u, r)
    assert thomas.launches == before + 1
    want = thomas.block_thomas_plain(d, u, r)
    torch.cuda.synchronize()
    assert got.shape == r.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TOL[dtype], rel


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
def test_wrapper_checks_on_cuda(cuda):
    d, u, r = _system(7, (2, 4, 5), "diag_dominant", torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        thomas.block_thomas_solve(d.transpose(-1, -2), u, r)
    with pytest.raises(ValueError, match="one device"):
        thomas.block_thomas_solve(d, u, r.cpu())
    big = 200
    with pytest.raises(ValueError, match="shared memory"):
        thomas.block_thomas_solve(
            torch.zeros(1, 2, big, big, dtype=torch.float64, device=cuda),
            torch.zeros(1, 2, big, big, dtype=torch.float64, device=cuda),
            torch.zeros(1, 2, big, dtype=torch.float64, device=cuda))
