"""The float32 KKT systems of the port's flagship runs on a CUDA card, each
solved several ways as the staged interior-point solver solves it, and the
paired comparison of the ways.

The staged solver (``dlp_admm_torch/solvers/ip_staged.py``) solves each IP
trip's KKT system with one block solve, refines the solution twice through
the same solve, checks the tridiagonal residual and rejects (``bad``) a
solve whose residual passes ``1e-4 (1 + max|rhs|)``: a rejected solve
becomes a zero step. The 42-step runs are chaotic in their conflict window,
so a run-level comparison cannot see a small bias in that solve; a paired
one on identical systems has no chaos in it.

``capture`` (a CUDA card, or ``--device cpu``): the 42-step float32 flagship
from the unmoved start (``--unmoved``) and from starts moved as
``tools/perturbed_torch_flagship.py`` moves them (``--seeds``, ``--noise``),
one process a run (``--jobs``). A stand-in for
``ip_staged.block_thomas_solve`` keeps the first call of every KKT solve in
the steps ``--window`` (the two refinement calls reuse its blocks), with the
step, the IP trip, the run's own ``bad`` per lane and the lane's final
``converged`` (``nlp_ok``); sampled evenly by order to ``--per-run`` calls.
Writes ``DIR/corpus_<label>.npz`` (per family of block width, the blocks'
entries at the positions non-zero in some kept lane, see
:func:`pack`) and ``DIR/run_<label>.json`` (the run's gates and per-step
ADMM iterations).

``solve``: every corpus call, in its own shape, through the arms
``--arms``:

* ``kernel``: ``ip_staged.block_thomas_solve`` on the card (K1, float32
  equilibrated), what the port runs;
* ``plain``: ``thomas.block_thomas_plain(..., equilibrate=True)`` on
  ``--device``;
* ``jax``: ``dlp_admm_tpu.solvers.ip_staged.block_thomas_solve`` on the CPU
  in float32 (64-bit off, matmul precision float32), with JAX's refinement
  and verification (``ip_staged.py:336-365``), vmapped over the lanes;
* ``truth``: the float64 dense solve of the raised inputs
  (``chip_smoke.dense_system``, ``torch.linalg.solve``).

Writes per lane the final solution (before a rejected one is zeroed), ``bad``
and the arm's own scaled residual to ``--out`` (one ``.npz`` an arm set; an
arm named ``<arm>_<device>``, ``jax`` and ``truth`` alone).

``report``: per arm the count of ``bad`` and the median and 90 % of the
scaled residuals (the arm's own float32 one and the float64 one) and of the
forward error ``max|x - x*| / max|x*|``, then every pair of arms under the
rule of ``PERF.md`` §6: arm A loses to arm B if an exact McNemar
test on ``bad`` gives p < 0.01 with A rejecting more, or a Wilcoxon
signed-rank test on ``log10(err_A / err_B)`` gives p < 0.01 with a median
above 0.3; the same restricted to the systems of steps at the ADMM cap and
to lanes whose solve did not converge. ``--sample PATH`` writes the lanes
where K1's and its plain version's errors differ most from JAX's
(``--sample-arms``), with their ``bad`` and errors and the truth
(``tests/data/kkt_f32_sample.npz``).

Usage:
  python3 tools/kkt_corpus.py capture --unmoved --seeds 5 8 --jobs 3
      --out DIR [--window 10-30] [--per-run 2000]
  python3 tools/kkt_corpus.py solve --corpus DIR --arms kernel plain
      --device cuda --out DIR/arms_cuda.npz
  python3 tools/kkt_corpus.py solve --corpus DIR --arms plain jax truth
      --device cpu --out DIR/arms_cpu.npz
  python3 tools/kkt_corpus.py report --corpus DIR --results A.npz B.npz
      [--json PATH] [--sample PATH [--sample-arms jax kernel_cuda plain_cuda]]
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import check_torch_window as cw  # noqa: E402
import chip_smoke  # noqa: E402
from dlp_admm_torch.models import obca  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.solvers import ip_staged, thomas  # noqa: E402

N_REFINE = chip_smoke.IP_REFINE_F32
RES_TOL = chip_smoke.IP_RES_TOL
ERR_CAP = 1e30          # the forward error of a non-finite solution
ERR_FLOOR = 1e-12       # errors below float32's reach count as equal
ALPHA = 0.01
MEDIAN_LOSS = 0.3       # log10: A's error at least twice B's
PLAIN_CALLS = 128       # calls the plain version and the truth take at once
META = ("run", "call", "lane", "step", "solve", "trip", "bad_run", "nlp_ok",
        "capped")


# -- the arms ---------------------------------------------------------------

def plain_solve(d, u, r):
    return thomas.block_thomas_plain(d, u, r, True)


def jax_arm():
    """JAX's float32 stage solve with its refinement and verification
    (``dlp_admm_tpu/solvers/ip_staged.py:336-365``), vmapped over lanes:
    ``f(d, u, r) -> (sol, bad, scaled)`` on numpy float32 arrays."""
    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dlp_admm_tpu.solvers import ip_staged as jip

    def one(d_blk, u_blk, rhs):
        t, bb = rhs.shape
        dtype = rhs.dtype
        u_pad = jnp.concatenate([u_blk[:t - 1],
                                 jnp.zeros((1, bb, bb), dtype)], axis=0)
        u_prev = jnp.concatenate([jnp.zeros((1, bb, bb), dtype),
                                  u_pad[:-1]], axis=0)

        def tridiag_residual(vec):
            nxt = jnp.concatenate([vec[1:], jnp.zeros((1, bb), dtype)],
                                  axis=0)
            prv = jnp.concatenate([jnp.zeros((1, bb), dtype), vec[:-1]],
                                  axis=0)
            return (jnp.einsum('tij,tj->ti', d_blk, vec)
                    + jnp.einsum('tij,tj->ti', u_pad, nxt)
                    + jnp.einsum('tji,tj->ti', u_prev, prv) - rhs)

        sol = jip.block_thomas_solve(d_blk, u_blk, rhs)
        for _ in range(N_REFINE):
            sol = sol - jip.block_thomas_solve(d_blk, u_blk,
                                               tridiag_residual(sol))
        lin_res = tridiag_residual(sol)
        top = jnp.max(jnp.abs(rhs), initial=0.0)
        res = jnp.max(jnp.abs(lin_res), initial=0.0)
        bad = jnp.logical_or(jnp.logical_not(jnp.all(jnp.isfinite(sol))),
                             res > RES_TOL * (1.0 + top))
        return sol, bad, res / (1.0 + top)

    fn = jax.jit(jax.vmap(one))

    def run(d, u, r):
        with jax.enable_x64(False), jax.default_matmul_precision("float32"):
            out = fn(jnp.asarray(d, jnp.float32), jnp.asarray(u, jnp.float32),
                     jnp.asarray(r, jnp.float32))
            return tuple(np.asarray(x) for x in out)
    return run


def truth(d, u, r):
    """The float64 dense solution ``[S, T, B]`` of the raised system."""
    a, rr = chip_smoke.dense_system(d.double(), u.double(), r.double())
    return torch.linalg.solve(a, rr).reshape(r.shape)


# -- capture ----------------------------------------------------------------

class Capture:
    """Stands in for ``ip_staged.block_thomas_solve`` (every call goes on to
    ``solve``) and keeps, in the steps of ``window``, the first call of each
    KKT solve with the run's own ``bad`` of that solve (recomputed from the
    same tensors as the staged solver does) and the lane's final
    ``converged``. Under CUDA graph capture the copies are recorded into
    the trip's graph, and :meth:`on_trip` reads them after each replay.
    ``limit`` stops the run (:class:`Enough`) once that many calls are
    kept; the last solve's lanes then carry their flags so far.
    """

    class Enough(Exception):
        pass

    def __init__(self, solve, window, limit=None):
        self.solve, self.window, self.limit = solve, set(window), limit
        self.step, self.solve_id, self.calls = None, 0, 0
        self.first = self.r0 = self.x0 = self.c1 = self.bad = None
        self.pending, self.kept = [], []

    def __call__(self, d, u, r):
        i = self.calls % (1 + N_REFINE)
        self.calls += 1
        out = self.solve(d, u, r)
        if self.step not in self.window:
            return out
        if i == 0:
            self.first = (d.clone(), u.clone(), r.clone())
            self.r0, self.x0 = r, out
        elif i == 1:
            self.c1 = out
        else:                  # sol = (x0 - c1) - c2, as the solver forms it
            self.bad = chip_smoke.ip_verify(
                ip_staged, d, u, self.r0, self.x0 - self.c1 - out)[0]
        return out

    def on_trip(self, trip, carry, trips):
        if trips == 0 or self.step not in self.window or self.first is None:
            return
        d, u, r = (x.cpu().numpy() for x in self.first)
        self.pending.append(dict(d=d, u=u, r=r, trip=trips,
                                 step=self.step, solve=self.solve_id,
                                 bad_run=self.bad.cpu().numpy()))
        if self.limit is not None and (len(self.kept) + len(self.pending)
                                       >= self.limit):
            done = carry.done.cpu().numpy()     # the lanes' flags so far
            for rec in self.pending:
                rec["nlp_ok"] = done
            self.kept += self.pending
            raise Capture.Enough

    def solve_staged(self, real):
        def wrapped(*args, **kwargs):
            self.solve_id += 1
            self.pending, self.first = [], None
            sol = real(*args, **kwargs)
            ok = sol.converged.cpu().numpy()
            for rec in self.pending:
                rec["nlp_ok"] = ok
            self.kept += self.pending
            self.pending, self.first = [], None
            return sol
        return wrapped

    def mpc_step(self, real):
        def wrapped(planner, init_state, bs, k):
            self.step = int(k)
            return real(planner, init_state, bs, k)
        return wrapped


class patched:
    """Install a :class:`Capture` around a run: the block solve, the staged
    solve the planner calls, the planner's MPC step and the trip hook."""

    def __init__(self, cap):
        self.cap = cap

    def __enter__(self):
        self.saved = (ip_staged.block_thomas_solve, ip_staged.on_trip,
                      obca.solve_staged, ConsensusObcaPlanner._mpc_step)
        ip_staged.block_thomas_solve = self.cap
        ip_staged.on_trip = self.cap.on_trip
        obca.solve_staged = self.cap.solve_staged(self.saved[2])
        ConsensusObcaPlanner._mpc_step = self.cap.mpc_step(self.saved[3])
        return self.cap

    def __exit__(self, *exc):
        (ip_staged.block_thomas_solve, ip_staged.on_trip, obca.solve_staged,
         ConsensusObcaPlanner._mpc_step) = self.saved
        return False


def capture_step(data, k, device, n_calls):
    """The first ``n_calls`` first calls of the KKT solves of step ``k`` of
    the float32 flagship from a carry file (``tools/make_window_carries.py``
    format), as :class:`Capture` keeps them; the step is cut there."""
    pl = ConsensusObcaPlanner(device=device,
                              **chip_smoke.flagship_profile(torch.float32))
    st, bs = cw.load_carry(data, k, device)
    cap = Capture(ip_staged.block_thomas_solve, [k], limit=n_calls)
    with patched(cap):
        try:
            pl._mpc_step(st, bs, k)
        except Capture.Enough:
            pass
    return cap.kept[:n_calls]


def pack(recs, run, capped_steps):
    """Per block width, the kept calls as lane rows: the entries of
    ``d``/``u`` at the positions whose bits are non-zero in some lane
    (``mask_d``, ``mask_u`` ``[T, B, B]``), ``rhs`` whole, and each lane's
    metadata; :func:`unpack` gives the blocks back bit for bit."""
    out = {}
    for b in sorted({rec["r"].shape[-1] for rec in recs}):
        fam = [rec for rec in recs if rec["r"].shape[-1] == b]
        d = np.concatenate([rec["d"] for rec in fam])
        u = np.concatenate([rec["u"] for rec in fam])
        mask_d = (d.view(np.uint32) != 0).any(axis=0)
        mask_u = (u.view(np.uint32) != 0).any(axis=0)
        meta = {m: [] for m in META}
        for i, rec in enumerate(fam):
            s = rec["r"].shape[0]
            for lane in range(s):
                vals = dict(run=run, call=i, lane=lane, step=rec["step"],
                            solve=rec["solve"], trip=rec["trip"],
                            bad_run=bool(rec["bad_run"][lane]),
                            nlp_ok=bool(rec["nlp_ok"][lane]),
                            capped=rec["step"] in capped_steps)
                for m in META:
                    meta[m].append(vals[m])
        f = f"b{b}"
        out.update({f"{f}_mask_d": mask_d, f"{f}_mask_u": mask_u,
                    f"{f}_d": d[:, mask_d], f"{f}_u": u[:, mask_u],
                    f"{f}_rhs": np.concatenate([rec["r"] for rec in fam])})
        out.update({f"{f}_{m}": np.asarray(v) for m, v in meta.items()
                    if m != "run"})
    return out


def unpack(z, f):
    """``(d, u, r)`` lane rows ``[N, T, B, B]`` ... of family ``f``."""
    mask_d, mask_u = z[f"{f}_mask_d"], z[f"{f}_mask_u"]
    r = z[f"{f}_rhs"]
    d = np.zeros((r.shape[0],) + mask_d.shape, np.float32)
    u = np.zeros((r.shape[0],) + mask_u.shape, np.float32)
    d[:, mask_d] = z[f"{f}_d"]
    u[:, mask_u] = z[f"{f}_u"]
    return d, u, r


def families(z):
    return sorted(k[:-len("_mask_d")] for k in z.files
                  if k.endswith("_mask_d"))


def capture_one(args, seed):
    """One run with the stand-in installed; writes its corpus and record."""
    import perturbed_torch_flagship as ptf
    label = ptf.label(seed)
    ref = np.load(chip_smoke.FIXTURE_F32)
    window = cw.step_list(args.window)
    cap = Capture(ip_staged.block_thomas_solve, window)
    run_args = types.SimpleNamespace(noise=args.noise, device=args.device,
                                     steps=args.steps, carries=None,
                                     dtype="f32")
    t0 = time.perf_counter()
    with patched(cap):
        run, per_step = ptf.one_run(run_args, seed, torch.float32, ref)
    wall = time.perf_counter() - t0
    its = run["iterations"]
    cap_iters = chip_smoke.flagship_profile(
        torch.float32)["ocfg"].max_admm_iters
    capped = {k for k, n in enumerate(its) if n >= cap_iters}
    n = len(cap.kept)
    keep = np.unique(np.round(np.linspace(0, n - 1, min(n, args.per_run)))
                     .astype(int)) if n else np.zeros(0, int)
    recs = [cap.kept[i] for i in keep]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"corpus_{label}.npz")
    np.savez_compressed(path, label=np.asarray(label),
                        **pack(recs, label, capped))
    info = dict({k: v for k, v in run.items() if k not in ptf.PER_STEP},
                label=label, window=window, first_calls_in_window=n,
                kept_calls=len(recs), capped_steps=sorted(capped),
                run_bad_lanes=int(sum(int(r["bad_run"].sum()) for r in recs)),
                corpus_bytes=os.path.getsize(path), capture_wall_s=wall,
                nvidia_smi=(chip_smoke.nvidia_smi() if args.device == "cuda"
                            else "cpu"))
    with open(os.path.join(args.out, f"run_{label}.json"), "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps({k: v for k, v in info.items() if k != "iterations"}),
          flush=True)


def capture(args):
    seeds = ([None] if args.unmoved else []) + list(args.seeds)
    if len(seeds) == 1 or args.jobs <= 1:
        for seed in seeds:
            capture_one(args, seed)
        return
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    base = [sys.executable, os.path.abspath(__file__), "capture",
            "--noise", str(args.noise), "--device", args.device,
            "--window", args.window, "--per-run", str(args.per_run),
            "--out", args.out, "--jobs", "1"]
    if args.steps is not None:
        base += ["--steps", str(args.steps)]
    procs = []
    for i in range(0, len(seeds), args.jobs):
        for seed in seeds[i:i + args.jobs]:
            cmd = base + (["--unmoved", "--seeds"] if seed is None
                          else ["--seeds", str(seed)])
            procs.append(subprocess.Popen(cmd, env=env))
        for p in procs:
            if p.wait() != 0:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"a capture exited with {p.returncode}")
        procs = []


# -- solve --------------------------------------------------------------------

def corpus_files(path):
    return sorted(glob.glob(os.path.join(path, "corpus_*.npz")))


def calls(path, per=1):
    """The corpus calls in a fixed order, ``per`` consecutive calls of one
    family at a time: ``(file, family, lane rows, d, u, r)``, the blocks as
    numpy float32 with the calls' lanes along the first axis (``per = 1``:
    each call in its own shape)."""
    for name in corpus_files(path):
        z = np.load(name)
        for f in families(z):
            d, u, r = unpack(z, f)
            call = z[f"{f}_call"]
            groups = np.split(np.arange(len(call)),
                              np.flatnonzero(np.diff(call)) + 1)
            for i in range(0, len(groups), per):
                rows = np.concatenate(groups[i:i + per])
                yield (os.path.basename(name), f, rows,
                       d[rows], u[rows], r[rows])


def solve(args):
    """Each arm over the corpus: the kernel and JAX one call at a time, in
    the call's own shape, as the run (the kernel arm's ``bad`` is then the
    run's own) and the JAX planner (vmapped over the call's lanes) solve
    it; the plain version and the truth over ``PLAIN_CALLS`` calls at a
    time (the plain version's lanes are independent; only its matrix
    products' order of summation may follow the batch)."""
    dev = torch.device(args.device)
    arms = {}
    for arm in args.arms:
        if arm == "kernel":
            if dev.type != "cuda":
                raise ValueError("the kernel arm runs on a CUDA device")
            arms["kernel_" + dev.type] = arm
        elif arm == "plain":
            arms["plain_" + dev.type] = arm
        elif arm in ("jax", "truth"):
            arms[arm] = arm
        else:
            raise ValueError(f"unknown arm {arm}")
    jax_fn = jax_arm() if "jax" in arms else None
    t0 = time.perf_counter()
    arrays, n_lanes = {}, 0
    for name, arm in arms.items():
        xs, bads, scaled = [], [], []
        per = PLAIN_CALLS if arm in ("plain", "truth") else 1
        for _, _, _, d, u, r in calls(args.corpus, per):
            if arm == "jax":
                x, bad, sc = jax_fn(d, u, r)
            elif arm == "truth":
                x = truth(*(torch.as_tensor(a) for a in (d, u, r))).numpy()
                bad, sc = np.zeros(len(r), bool), np.zeros(len(r))
            else:
                fn = (ip_staged.block_thomas_solve if arm == "kernel"
                      else plain_solve)
                x, bad, sc = (v.cpu().numpy() for v in chip_smoke.ip_solve(
                    ip_staged, fn, *(torch.as_tensor(a, device=dev)
                                     for a in (d, u, r))))
            xs.append(np.asarray(x).reshape(len(r), -1))
            bads.append(np.asarray(bad, bool))
            scaled.append(np.asarray(sc, np.float64))
        width = max(x.shape[1] for x in xs)
        arrays[f"{name}__x"] = np.concatenate([np.pad(
            x, ((0, 0), (0, width - x.shape[1])), constant_values=np.nan)
            for x in xs])
        arrays[f"{name}__bad"] = np.concatenate(bads)
        arrays[f"{name}__scaled"] = np.concatenate(scaled)
        n_lanes = len(arrays[f"{name}__bad"])
        print(json.dumps(dict(arm=name, lanes=n_lanes, seconds=round(
            time.perf_counter() - t0, 1))), flush=True)
    smi = chip_smoke.nvidia_smi() if dev.type == "cuda" else "cpu"
    np.savez_compressed(args.out, arms=np.asarray(list(arms)),
                        files=np.asarray(corpus_files(args.corpus)),
                        nvidia_smi=np.asarray(smi), **arrays)
    print(json.dumps(dict(arms=list(arms), lanes=n_lanes,
                          seconds=round(time.perf_counter() - t0, 1),
                          device=str(dev), nvidia_smi=smi)), flush=True)


# -- the rule -----------------------------------------------------------------

def mcnemar(bad_a, bad_b):
    """Exact McNemar test on paired flags: ``(A only, B only, p)``, the
    two-sided binomial p on the discordant pairs (1 if there are none)."""
    a_only = int(np.sum(bad_a & ~bad_b))
    b_only = int(np.sum(bad_b & ~bad_a))
    return a_only, b_only, chip_smoke.mcnemar_p(a_only, b_only)


def wilcoxon_log_ratio(err_a, err_b):
    """``(median, p)`` of ``log10(err_a / err_b)``: its median over all
    pairs and the two-sided Wilcoxon signed-rank p (zero differences
    dropped; 1 if every difference is zero)."""
    from scipy.stats import wilcoxon
    lr = np.log10(err_a) - np.log10(err_b)
    med = float(np.median(lr)) if lr.size else 0.0
    if not np.any(lr != 0):
        return med, 1.0
    return med, float(wilcoxon(lr, zero_method="wilcox").pvalue)


def loses(bad_a, err_a, bad_b, err_b):
    """The rule: does arm A lose to arm B? ``(verdict, details)``."""
    a_only, b_only, p_mc = mcnemar(bad_a, bad_b)
    med, p_w = wilcoxon_log_ratio(err_a, err_b)
    by_bad = p_mc < ALPHA and a_only > b_only
    by_err = p_w < ALPHA and med > MEDIAN_LOSS
    return by_bad or by_err, dict(a_only_bad=a_only, b_only_bad=b_only,
                                  mcnemar_p=p_mc, log_ratio_median=med,
                                  wilcoxon_p=p_w, by_bad=by_bad,
                                  by_error=by_err)


def errors(x, x_true):
    """Forward error ``max|x - x*| / max|x*|`` per lane row (NaN padding
    ignored), at least :data:`ERR_FLOOR`; a non-finite solution gets
    :data:`ERR_CAP`."""
    pad = np.isnan(x_true)
    diff = np.where(pad, 0.0, np.abs(x.astype(np.float64) - x_true))
    top = np.where(pad, 0.0, np.abs(x_true)).max(axis=1)
    finite = np.all(np.isfinite(x) | pad, axis=1)
    err = diff.max(axis=1) / np.maximum(top, 1e-300)
    return np.where(finite, np.clip(err, ERR_FLOOR, ERR_CAP), ERR_CAP)


def residual64(x, path):
    """The float64 scaled residual ``max|A x - r| / (1 + max|r|)`` of each
    lane's solution ``x`` (rows in :func:`calls` order)."""
    out, i = [], 0
    for _, _, rows, d, u, r in calls(path, PLAIN_CALLS):
        n, (t, b) = len(rows), r.shape[1:]
        xs = torch.as_tensor(x[i:i + n, :t * b].reshape(n, t, b)).double()
        dt, ut, rt = (torch.as_tensor(a).double() for a in (d, u, r))
        res = chip_smoke.tridiag_residual(dt, ut, rt, torch.nan_to_num(
            xs, nan=0.0, posinf=0.0, neginf=0.0)).abs().amax((1, 2))
        top = rt.abs().amax((1, 2))
        out.append((res / (1.0 + top)).numpy())
        i += n
    return np.concatenate(out)


def corpus_meta(path):
    """Every lane's metadata in :func:`calls` order."""
    meta = {m: [] for m in META + ("family",)}
    for name in corpus_files(path):
        z = np.load(name)
        for f in families(z):
            n = len(z[f"{f}_call"])
            meta["run"].append(np.full(n, str(z["label"])))
            meta["family"].append(np.full(n, f))
            for m in META[1:]:
                meta[m].append(z[f"{f}_{m}"])
    return {m: np.concatenate(v) for m, v in meta.items()}


def summarize(bad, scaled, res64, err):
    """An arm's count of ``bad`` and the median and 90 % of its residuals
    and errors (a non-finite residual counts as infinite)."""
    def q(v, p):
        v = np.nan_to_num(v, nan=np.inf)
        return float(np.quantile(v, p)) if v.size else float("nan")
    return dict(lanes=int(bad.size), bad=int(bad.sum()),
                scaled_median=q(scaled, 0.5), scaled_p90=q(scaled, 0.9),
                res64_median=q(res64, 0.5), res64_p90=q(res64, 0.9),
                err_median=q(err, 0.5), err_p90=q(err, 0.9))


def table(arms, sel):
    """Per arm its summary and every ordered pair under the rule, on the
    lanes ``sel``."""
    names = [a for a in arms if a != "truth"]
    per_arm = {a: summarize(arms[a]["bad"][sel], arms[a]["scaled"][sel],
                            arms[a]["res64"][sel], arms[a]["err"][sel])
               for a in names}
    pairs = []
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            a_loses, det_ab = loses(arms[a]["bad"][sel], arms[a]["err"][sel],
                                    arms[b]["bad"][sel], arms[b]["err"][sel])
            b_loses, _ = loses(arms[b]["bad"][sel], arms[b]["err"][sel],
                               arms[a]["bad"][sel], arms[a]["err"][sel])
            pairs.append(dict(a=a, b=b, a_loses=a_loses, b_loses=b_loses,
                              **det_ab))
    return dict(arms=per_arm, pairs=pairs)


def outcome(pairs, kernel, plain_card, plain_cpu):
    """A, B or C from the deciding pairs of the rule (``other`` if none
    of them holds)."""
    def lost(x, y):
        for p in pairs:
            if (p["a"], p["b"]) == (x, y):
                return p["a_loses"]
            if (p["a"], p["b"]) == (y, x):
                return p["b_loses"]
        raise KeyError((x, y))
    to_jax = {a: lost(a, "jax") for a in (kernel, plain_card, plain_cpu)}
    if to_jax[kernel] and to_jax[plain_cpu]:
        return "A"
    if lost(kernel, plain_card) and not (to_jax[plain_card]
                                          or to_jax[plain_cpu]):
        return "B"
    if not any(to_jax.values()):
        return "C"
    return "other"


def load_arms(results, path):
    arms = {}
    for name in results:
        z = np.load(name)
        if list(z["files"]) and [os.path.basename(f) for f in z["files"]] != [
                os.path.basename(f) for f in corpus_files(path)]:
            raise ValueError(f"{name} was solved on another corpus")
        for a in z["arms"]:
            arms[str(a)] = dict(x=z[f"{a}__x"], bad=z[f"{a}__bad"],
                                scaled=z[f"{a}__scaled"])
    if "truth" not in arms:
        raise ValueError("the truth arm is needed for the forward errors")
    for a, rec in arms.items():
        rec["err"] = errors(rec["x"], arms["truth"]["x"])
        rec["res64"] = residual64(rec["x"], path)
    return arms


def report(args):
    arms = load_arms(args.results, args.corpus)
    meta = corpus_meta(args.corpus)
    n = len(meta["call"])
    subsets = dict(all=np.ones(n, bool), capped_steps=meta["capped"],
                   nlp_not_ok=~meta["nlp_ok"])
    for fam in sorted(set(meta["family"])):
        subsets[fam] = meta["family"] == fam
    rep = dict(lanes=n, runs=sorted(set(meta["run"])),
               calls=len(set(zip(meta["run"], meta["family"], meta["call"]))),
               subsets={})
    if "kernel_cuda" in arms:
        rep["kernel_bad_equals_run_bad"] = int(
            (arms["kernel_cuda"]["bad"] == meta["bad_run"]).sum())
    for name, sel in subsets.items():
        tab = table(arms, sel)
        if {"kernel_cuda", "plain_cuda", "plain_cpu", "jax"} <= set(arms):
            tab["outcome"] = outcome(tab["pairs"], "kernel_cuda",
                                     "plain_cuda", "plain_cpu")
        rep["subsets"][name] = tab
    print_report(rep)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
    if args.sample:
        write_sample(args, arms, meta)


def print_report(rep):
    print(f"{rep['lanes']} lane systems of {rep['calls']} calls, runs "
          f"{', '.join(rep['runs'])}")
    if "kernel_bad_equals_run_bad" in rep:
        print(f"kernel arm's bad == the run's own: "
              f"{rep['kernel_bad_equals_run_bad']} of {rep['lanes']}")
    for name, tab in rep["subsets"].items():
        print(f"\n[{name}]" + (f" outcome {tab['outcome']}"
                              if "outcome" in tab else ""))
        for a, s in tab["arms"].items():
            print(f"  {a:12s} lanes {s['lanes']:6d} bad {s['bad']:5d}  "
                  f"res32 {s['scaled_median']:.3e} / {s['scaled_p90']:.3e}  "
                  f"res64 {s['res64_median']:.3e} / {s['res64_p90']:.3e}  "
                  f"err {s['err_median']:.3e} / {s['err_p90']:.3e}")
        for p in tab["pairs"]:
            flag = ("A loses" if p["a_loses"] else "") + (
                "B loses" if p["b_loses"] else "")
            print(f"  {p['a']:12s} vs {p['b']:12s} bad only {p['a_only_bad']}"
                  f"/{p['b_only_bad']} McNemar p {p['mcnemar_p']:.3g}; "
                  f"log10 ratio median {p['log_ratio_median']:+.3f} Wilcoxon "
                  f"p {p['wilcoxon_p']:.3g} {flag}")


def write_sample(args, arms, meta, per_side=100):
    """The lanes where each of the ``--sample-arms`` after the first differs
    most in forward error from the first (``per_side`` where it is the
    worse and ``per_side`` where it is the better), with every sample arm's
    ``bad`` and errors and the truth. Taking the extremes of K1 and of its
    plain version alike keeps the sample from favouring either: the
    extremes of one arm alone hold its own rejections."""
    ref, *others = args.sample_arms
    picks = []
    for arm in others:
        lr = np.log10(arms[arm]["err"]) - np.log10(arms[ref]["err"])
        order = np.argsort(lr, kind="stable")
        picks += [order[:per_side], order[-per_side:]]
    pick = np.unique(np.concatenate(picks))
    lanes = {i: (f, d, u, r)
             for i, (_, f, _, d, u, r) in enumerate(_lane_rows(args.corpus))}
    out = {}
    for fam in sorted({lanes[i][0] for i in pick}):
        idx = [i for i in pick if lanes[i][0] == fam]
        r = np.stack([lanes[i][3] for i in idx])
        t, b = r.shape[1:]
        out.update({f"{fam}_d": np.stack([lanes[i][1] for i in idx]),
                    f"{fam}_u": np.stack([lanes[i][2] for i in idx]),
                    f"{fam}_rhs": r,
                    f"{fam}_truth": arms["truth"]["x"][idx, :t * b]
                    .reshape(len(idx), t, b),
                    f"{fam}_step": meta["step"][idx],
                    f"{fam}_run": meta["run"][idx]})
        for arm in args.sample_arms:
            out[f"{fam}_{arm}_bad"] = arms[arm]["bad"][idx]
            out[f"{fam}_{arm}_err"] = arms[arm]["err"][idx]
    np.savez_compressed(args.sample, arms=np.asarray(args.sample_arms),
                        **out)
    print(f"sample: {len(pick)} lanes, {os.path.getsize(args.sample)} bytes "
          f"-> {args.sample}; bad " + ", ".join(
              f"{a} {int(arms[a]['bad'][pick].sum())}"
              for a in args.sample_arms))


def _lane_rows(path):
    """Every lane alone, in :func:`calls` order: ``(file, family, row,
    d [T, B, B], u, r [T, B])``."""
    for name, f, rows, d, u, r in calls(path):
        for j, row in enumerate(rows):
            yield name, f, row, d[j], u[j], r[j]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("--unmoved", action="store_true")
    c.add_argument("--seeds", type=int, nargs="*", default=[])
    c.add_argument("--noise", type=float, default=1e-7)
    c.add_argument("--window", default="10-30")
    c.add_argument("--per-run", type=int, default=2000)
    c.add_argument("--jobs", type=int, default=1)
    c.add_argument("--device", default="cuda")
    c.add_argument("--steps", type=int, default=None,
                   help="MPC steps (default 42; fewer only to rehearse)")
    c.add_argument("--out", required=True)
    s = sub.add_parser("solve")
    s.add_argument("--corpus", required=True)
    s.add_argument("--arms", nargs="+", required=True)
    s.add_argument("--device", default="cpu")
    s.add_argument("--out", required=True)
    r = sub.add_parser("report")
    r.add_argument("--corpus", required=True)
    r.add_argument("--results", nargs="+", required=True)
    r.add_argument("--json", default=None)
    r.add_argument("--sample", default=None)
    r.add_argument("--sample-arms", nargs="+",
                   default=("jax", "kernel_cuda", "plain_cuda"))
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.cmd == "capture":
        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("needs a CUDA card (or --device cpu)")
        capture(args)
    elif args.cmd == "solve":
        solve(args)
    else:
        report(args)


if __name__ == "__main__":
    main()
