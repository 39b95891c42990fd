"""Smoke run of the PyTorch port on one CUDA card.

Drives ``dlp_admm_torch`` (never JAX) through its main path and checks it:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the block-Thomas kernel (``dlp_admm_torch/csrc/``) for
   ``sm_90a`` with ``nvcc`` and prints the build time;
3. kernel vs plain version on the card, float64 and float32, at
   (S, T, B) = (2, 7, 19), (1, 7, 20), (32, 7, 19), (256, 7, 19), on
   diagonally dominant, KKT-style saddle and zero-leading-block saddle
   systems made with numpy from a fixed seed (tolerances below);
4. the slice: ``dlp_admm_torch.mpc.run_obca(Formulation.CONSENSUS, ...)``
   on the card in float64 with the flagship profile, first 6 MPC steps,
   held against the committed JAX run ``tests/data/consensus_obca_f64_ref.npz``
   (states within 1e-6, equal ADMM iteration counts), with the kernel's
   launch count equal to the staged solver's block-solve count; then the
   kernel against its plain version on the KKT blocks captured from the
   run's first local and edge IP trips;
5. ``--full``: all 42 steps, gated on the pins of
   ``tests/test_flagship_convergence.py``.

Prints, before the last line, one JSON object with the kernel's numbers and
the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0) and
prints no result.

Usage: python3 chip_smoke.py [--full] [--out PATH.json]
"""
import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "consensus_obca_f64_ref.npz")
SHAPES = ((2, 7, 19), (1, 7, 20), (32, 7, 19), (256, 7, 19))
# kernel vs plain version: both run the same recursion with the same pivot
# choice and pivot floor; only the order of summation inside each product
# differs, so the gap is rounding amplified by the blocks' conditioning
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
STATE_TOL = 1e-6            # port vs JAX fixture, float64 states
SMOKE_STEPS = 6
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


KINDS = ("diag_dominant", "kkt_saddle", "zero_lead")


def dump(path, records):
    if path:
        with open(path, "w") as f:
            json.dump(records, f, indent=1)


def make_system(rng, s, t, b, kind):
    """Symmetric block-tridiagonal [S, T, B, B] / upper / rhs (numpy f64):
    ``diag_dominant``; ``kkt_saddle``, KKT-style blocks (H, J^T; J, -eps I);
    ``zero_lead``, the same saddle with the constraint rows first and a zero
    (1, 1) block, which only an elimination that swaps rows can factor."""
    if kind == "diag_dominant":
        diag = rng.normal(size=(s, t, b, b))
        diag = 0.5 * (diag + np.swapaxes(diag, -1, -2)) + (b + 2.0) * np.eye(b)
        upper = 0.3 * rng.normal(size=(s, t, b, b))
    else:
        m = b // 4
        n = b - m
        r = rng.normal(size=(s, t, n, n))
        j = rng.normal(size=(s, t, m, n))
        h, c = (slice(0, n), slice(n, b)) if kind == "kkt_saddle" \
            else (slice(m, b), slice(0, m))
        diag = np.zeros((s, t, b, b))
        diag[..., h, h] = r @ np.swapaxes(r, -1, -2) + np.eye(n)
        diag[..., h, c] = np.swapaxes(j, -1, -2)
        diag[..., c, h] = j
        diag[..., c, c] = -1e-8 * np.eye(m) if kind == "kkt_saddle" else 0.0
        upper = np.zeros((s, t, b, b))
        upper[..., h, h] = 0.1 * rng.normal(size=(s, t, n, n))
    upper[:, t - 1] = 0.0
    return diag, upper, rng.normal(size=(s, t, b))


def time_ms(fn, reps):
    """Time per call of ``fn`` called eagerly (host dispatch included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured as one CUDA
    graph and replayed, which keeps host dispatch out, as in the IP loop."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return time_ms(graph.replay, 5) / reps


def compare(thomas, diag, upper, rhs, label, timed=False):
    """Kernel vs plain version on the same card tensors; raises past TOL."""
    got = thomas.block_thomas_solve(diag, upper, rhs)
    want = thomas.block_thomas_plain(diag, upper, rhs)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: kernel output not finite")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-300)
    row = dict(case=label, max_abs_err=abs_err, max_rel_err=rel_err,
               tol=TOL[rhs.dtype])
    if timed:
        def kernel():
            thomas.block_thomas_solve(diag, upper, rhs)

        def plain():
            thomas.block_thomas_plain(diag, upper, rhs)

        row.update(ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                   eager_ms=time_ms(kernel, 50),
                   plain_eager_ms=time_ms(plain, 5))
    log(json.dumps(row))
    if not rel_err <= TOL[rhs.dtype]:
        raise RuntimeError(f"{label}: kernel vs plain rel err {rel_err:.3e} "
                           f"> {TOL[rhs.dtype]:.0e}")
    return row


def flagship_profile(max_admm_iters=50):
    from dlp_admm_torch.config import ObcaConfig, SolverConfig
    # bench.py:207-212 with the float64 settings of bench.py:196-199
    return dict(ocfg=ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                                max_admm_iters=max_admm_iters),
                scfg=SolverConfig(ip_iters=40, ip_tol=1e-6),
                local_prox=700.0, prox_growth=1.5, prox_tau_max=3.0e10)


def main():
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on CUDA")
    ap.add_argument("--full", action="store_true",
                    help="also run all 42 MPC steps with the quality gates")
    ap.add_argument("--out", default=None,
                    help="write every record of this run to this JSON file")
    args = ap.parse_args()
    records = {}

    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    import dlp_admm_torch  # noqa: F401  (sets the TF32 switches)
    from dlp_admm_torch.config import Formulation
    from dlp_admm_torch.mpc import run_obca
    from dlp_admm_torch.solvers import ip_staged, thomas
    ref = np.load(FIXTURE)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = thomas.build()
    build_s = time.perf_counter() - t0
    log(f"build: block_thomas in {build_s:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            log("  " + line.strip())
    records["build_s"] = build_s

    # -- 3. kernel vs plain version -------------------------------------
    rng = np.random.default_rng(0)
    synth = []
    for dtype in (torch.float64, torch.float32):
        for s, t, b in SHAPES:
            for kind_ in KINDS:
                d, u, r = (torch.as_tensor(a, dtype=dtype, device=dev)
                           for a in make_system(rng, s, t, b, kind_))
                synth.append(compare(
                    thomas, d, u, r, f"{kind_} S={s} T={t} B={b} "
                    f"{str(dtype)[6:]}", timed=kind_ == "diag_dominant"))
    records["kernel_vs_plain"] = synth

    # -- 4. the slice ---------------------------------------------------
    captured = {}
    solve = ip_staged.block_thomas_solve

    def capture_first(diag, upper, rhs):
        key = tuple(rhs.shape)
        if key not in captured:
            captured[key] = (diag.clone(), upper.clone(), rhs.clone())
        return solve(diag, upper, rhs)

    ip_staged.block_thomas_solve = capture_first
    try:
        thomas.launches = 0
        res = run_obca(Formulation.CONSENSUS, n_steps=SMOKE_STEPS,
                       device=dev, dtype=torch.float64,
                       **flagship_profile())
        torch.cuda.synchronize()
        launches = thomas.launches
    finally:
        ip_staged.block_thomas_solve = solve
    pl = res.extras["planner"]
    check_slice(res, pl, ref, launches, dev)
    records["slice"] = slice_record(res, ref, launches, pl.block_solves)

    # the kernel on the KKT blocks the flagship gave it (first IP trips)
    real = [compare(thomas, *captured[k], f"flagship KKT S={k[0]} T={k[1]} "
                    f"B={k[2]} float64", timed=True) for k in sorted(captured)]
    if len(real) != 2:
        raise RuntimeError(f"expected local and edge KKT shapes, got "
                           f"{sorted(captured)}")
    records["kernel_on_flagship_blocks"] = real

    # -- 5. --full ------------------------------------------------------
    if args.full:
        records["full"] = run_full(run_obca, Formulation, ref, dev)
        dump(args.out, records)        # kept for diagnosis if a gate fails
        failed = [g for g, ok in records["full"]["gates"].items() if not ok]
        if failed:
            raise RuntimeError(f"--full quality gates failed: {failed}")

    main_path = max(real, key=lambda r: r["max_abs_err"])
    local = next(r for r in real if "S=2 " in r["case"])
    kernels = {"kernels": [{
        "name": "block_thomas", "route": "cuda",
        "source": "dlp_admm_torch/csrc/block_thomas.cu",
        "replaces": "dlp_admm_tpu/solvers/thomas_pallas.py:145",
        "launches": launches, "max_abs_err": main_path["max_abs_err"],
        "ms": local["ms"], "plain_ms": local["plain_ms"]}]}
    records.update(kernels, device=kind, nvidia_smi=smi)
    dump(args.out, records)
    log(json.dumps(kernels))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def check_slice(res, pl, ref, launches, dev):
    states = res.states
    n = len(res.metrics.iter_history)
    if n != SMOKE_STEPS or states.shape != (SMOKE_STEPS + 1, 2, 5):
        raise RuntimeError(f"slice ran {n} steps, states {states.shape}")
    if not np.all(np.isfinite(states)):
        raise RuntimeError("slice states not finite")
    err = float(np.abs(states - ref["states"][:n + 1]).max())
    its = np.asarray(res.metrics.iter_history)
    log(f"slice: max |state - JAX fixture| = {err:.3e} (tol {STATE_TOL:.0e})")
    if not err <= STATE_TOL:
        raise RuntimeError(f"slice states differ from the JAX fixture: {err}")
    if not np.array_equal(its, ref["iterations"][:n]):
        raise RuntimeError(f"ADMM iterations {its.tolist()} != JAX "
                           f"{ref['iterations'][:n].tolist()}")
    log(f"slice: kernel launches {launches}, staged block solves "
        f"{pl.block_solves}")
    if launches <= 0 or launches != pl.block_solves:
        raise RuntimeError(f"kernel launches {launches} != block solves "
                           f"{pl.block_solves}")
    st, bs = pl.carry
    for name, x in [("state", st)] + list(bs._asdict().items()):
        if x.device.type != dev.type:
            raise RuntimeError(f"final carry {name} lies on {x.device}")


def slice_record(res, ref, launches, block_solves):
    m = res.metrics
    p = res.states[..., :2]
    rows = res.extras["residuals"]
    per_step = [dict(step=t, iterations=m.iter_history[t], primal=r[0],
                     dual=r[1], gap=r[6], wall_s=m.step_times[t])
                for t, r in enumerate(rows)]
    for row in per_step:
        log(json.dumps(row))
    summary = m.summary()
    out = dict(steps=per_step, summary=summary, launches=launches,
               block_solves=block_solves,
               min_center_distance_m=float(
                   np.linalg.norm(p[:, 0] - p[:, 1], axis=-1).min()),
               max_state_err_vs_jax=float(
                   np.abs(res.states - ref["states"][:len(rows) + 1]).max()))
    log(f"slice: {summary['steps']} steps, wall {summary['total_time_s']:.3f} s"
        f", {summary.get('iterations_per_s', 0.0):.3f} ADMM it/s, min centre "
        f"distance {out['min_center_distance_m']:.4f} m")
    return out


def polygon_gap(p, q):
    """Distance between convex polygons ``p``, ``q`` [n, 2] in cyclic
    order; 0 when they touch or overlap (separating-axis test)."""
    def separated(a, b):
        for i in range(len(a)):
            e = a[(i + 1) % len(a)] - a[i]
            n = np.array([-e[1], e[0]])
            if (a @ n).max() < (b @ n).min() or (b @ n).max() < (a @ n).min():
                return True
        return False

    def point_seg(x, a, b):
        ab = b - a
        t = np.clip(np.dot(x - a, ab) / np.dot(ab, ab), 0.0, 1.0)
        return np.linalg.norm(x - (a + t * ab))

    if not (separated(p, q) or separated(q, p)):
        return 0.0
    return min(point_seg(x, b[i], b[(i + 1) % len(b)])
               for a, b in ((p, q), (q, p)) for x in a for i in range(len(b)))


def run_full(run_obca, Formulation, ref, dev):
    """All 42 steps and the gates of tests/test_flagship_convergence.py:38-74
    (``gates`` maps each to whether it held)."""
    from dlp_admm_torch.ops.geometry import vehicle_vertices
    res = run_obca(Formulation.CONSENSUS, device=dev, dtype=torch.float64,
                   **flagship_profile())
    m = res.metrics
    rows = res.extras["residuals"]
    states = res.states
    its = np.asarray(m.iter_history)
    prs = np.array([r[0] for r in rows])
    dus = np.array([r[1] for r in rows])
    oks = np.array([[r[2], r[3]] for r in rows])
    gaps = np.array([r[6] for r in rows])
    p = states[..., :2]
    d = np.linalg.norm(p[:, 0] - p[:, 1], axis=-1)
    res_ok = (prs <= 0.011) & (dus <= 0.011)
    n = len(its)
    gates = {
        "steps == 42": n == 42,
        "finite states": bool(np.all(np.isfinite(states))),
        "res_ok >= 40/42": int(res_ok.sum()) >= 40,
        "res_ok == (its < 50)": bool(np.array_equal(res_ok, its < 50)),
        "mean iterations < 24": float(its.mean()) < 24.0,
        "min distance > 3.8 m": float(d.min()) > 3.8,
        "overtake completed": bool(states[0, 0, 0] < states[0, 1, 0]
                                   and states[-1, 0, 0] > states[-1, 1, 0]),
        "nlp health >= 0.9": float(np.mean(oks == 1.0)) >= 0.9,
        "gap median < 0.02": float(np.median(gaps)) < 0.02,
        "gap max < 1.0": float(gaps.max()) < 1.0,
    }
    # the reference's own safety oracle: the vehicles' footprints never meet
    corners = vehicle_vertices(torch.as_tensor(states)).numpy()
    k = min(n, len(ref["iterations"]))
    out = dict(
        steps=n, res_ok=int(res_ok.sum()), mean_iterations=float(its.mean()),
        min_distance_m=float(d.min()),
        min_footprint_gap_m=float(min(polygon_gap(c[0], c[1])
                                      for c in corners)),
        health=float(np.mean(oks == 1.0)),
        gap_median=float(np.median(gaps)), gap_max=float(gaps.max()),
        summary=m.summary(), iterations=its.tolist(),
        step_wall_s=m.step_times, residual_rows=rows,
        states=states.tolist(), gates=gates,
        vs_jax=dict(
            max_state_err=float(np.abs(states[:k + 1]
                                       - ref["states"][:k + 1]).max()),
            first_state_err_above_1e_6=next(
                (t for t in range(k + 1) if np.abs(
                    states[t] - ref["states"][t]).max() > STATE_TOL), None),
            steps_with_other_iterations=[
                t for t in range(k) if its[t] != ref["iterations"][t]]))
    log("full: " + json.dumps({x: out[x] for x in (
        "steps", "res_ok", "mean_iterations", "min_distance_m",
        "min_footprint_gap_m", "health", "gap_median", "gap_max",
        "vs_jax")}))
    log(f"full: wall {m.summary()['total_time_s']:.3f} s, "
        f"{m.summary()['iterations_per_s']:.3f} ADMM it/s")
    return out


if __name__ == "__main__":
    main()
