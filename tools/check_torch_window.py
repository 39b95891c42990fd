"""One conflict-window MPC step of the PyTorch port's float32 flagship, from
the JAX run's own carry (``tools/make_window_carries.py``), and whether the
port's run repeats itself bit for bit.

Whole 42-step runs of the two planners cannot be compared step by step: the
conflict window is chaotic. Started from the same carry, one step can:

* ``--steps 13,14,...``: the step's ADMM iterations, residuals and NLP
  health through the IP loop the device takes (on a CUDA card a replayed
  CUDA graph), beside JAX's iteration count;
* ``--repeat N``: those steps (and with ``--slice`` the first 6 steps of the
  float32 run from its start, ``chip_smoke.py``'s slice) N times in this
  process, with a digest of the carry before the first and after every IP
  trip and of the ADMM carry after every ADMM iteration; prints, for every
  later call, the first trip and the tensors where it parts from the first
  call. ``--fresh K`` runs the same in K more processes and compares their
  first calls with this one's (the first call of a process included).
  ``--poison`` fills the CUDA caching allocator's free memory with NaN
  bytes before every call (a read of memory nothing wrote then shows as a
  NaN); ``--deterministic`` turns on ``torch.use_deterministic_algorithms``
  (an op that has no deterministic form raises and is named; set
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment with it);
  ``--graph-check N`` runs, in the first call and
  after the first trip of each of its first N solves, that trip once more
  as a captured and replayed CUDA graph and eagerly, every operator's
  outputs kept, and names the first operator whose outputs differ;
* ``--eager N``: the first N of the steps again through the eager IP loop
  on the same device (on the card: is the graphed loop the eager one?);
* ``--record PATH``: each of the steps once, its ADMM iterations,
  residuals, NLP health and KKT, consensus gap, next state and the planned
  states of the next carry (``local_x``) written as ``port_<k>_<field>``
  into ``PATH`` (``.npz``), the format of ``tools/jax_window_steps.py``;
  ``tools/compare_window_steps.py`` sets them beside JAX's steps from the
  same carries. ``--plain`` routes the staged solver's KKT solves to the
  plain version of the kernels on any device (a stand-in at this tool's
  level, as ``chip_smoke.CaptureFirst`` is), to tell the kernel's part
  from the rest of the card's arithmetic;
* ``--kkt-step K`` (CUDA): every ``--every``-th KKT system of step K's first
  ``--kkt-iters`` ADMM iterations, all IP trips included (eager loop),
  solved by the warp kernel, the wide kernel and the plain version:
  the residual the staged solver's own verification looks at,
  ``max |A x - r| / (1 + max |r|)``, of each, and how many single solves
  each would have rejected (> 1e-4).

The carries default to ``_chipcheck/carries_f32.npz`` where that file exists
and else to the committed ``tests/data/consensus_obca_f32_carry14.npz``
(step 14 only).

Usage: python3 tools/check_torch_window.py [--device cuda|cpu]
           [--carries PATH.npz] [--steps K,K,...|A-B] [--slice] [--repeat N]
           [--record PATH.npz [--plain]]
           [--fresh K] [--poison] [--deterministic] [--json PATH]
           [--graph-check N] [--eager N]
           [--kkt-step K --kkt-iters N --every M]
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dlp_admm_torch.config import Formulation  # noqa: E402
from dlp_admm_torch.interop import bar_state_from_numpy  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.mpc import run_obca  # noqa: E402
from dlp_admm_torch.solvers import ip_staged, thomas  # noqa: E402

WINDOW_CARRIES = os.path.join(ROOT, "_chipcheck", "carries_f32.npz")
STEP14_CARRY = os.path.join(ROOT, "tests", "data",
                            "consensus_obca_f32_carry14.npz")
SOLVES = ("local", "edge")


def default_carries():
    return WINDOW_CARRIES if os.path.exists(WINDOW_CARRIES) else STEP14_CARRY


def digest(x):
    """A short digest of a tensor's bytes (its values, bit for bit)."""
    a = x.detach().contiguous().cpu()
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    return hashlib.sha1(a.numpy().tobytes()).hexdigest()[:16]


def tensors_of(obj, prefix=""):
    """(name, tensor) of every tensor in a carry: a dict, NamedTuple or
    tensor, nested."""
    if isinstance(obj, torch.Tensor):
        yield prefix.rstrip(".") or "value", obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from tensors_of(v, f"{prefix}{k}.")
    elif hasattr(obj, "_asdict"):
        for k, v in obj._asdict().items():
            yield from tensors_of(v, f"{prefix}{k}.")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from tensors_of(v, f"{prefix}{i}.")


def port_frame():
    """file:line of the innermost frame of the port's own code."""
    for fr in reversed(traceback.extract_stack()):
        if "dlp_admm_torch" in fr.filename:
            return f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
    return "?"


class KeepOutputs(TorchDispatchMode):
    """Keeps (operator, its tensor outputs, the port's source line) of every
    operator inside the ``with``; works under CUDA graph capture, where
    nothing may be read."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.rows.append((str(func), [x for x in tree_flatten(out)[0]
                                      if isinstance(x, torch.Tensor)],
                          port_frame()))
        return out


def graph_vs_eager(trip, carry):
    """One IP trip from ``carry`` as the solver runs it on the card
    (captured as a CUDA graph on the capture stream, replayed on the
    current one) and eagerly on the current stream, every operator's
    outputs kept; returns the first operator whose outputs differ, or
    None."""
    dev = carry.w.device
    stream = ip_staged._capture_streams.setdefault(dev,
                                                   torch.cuda.Stream(dev))
    static = type(carry)(*(x.clone() for x in carry))
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        with KeepOutputs() as in_graph:
            trip(static)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph.replay()
    again = type(carry)(*(x.clone() for x in carry))
    with KeepOutputs() as eager:
        trip(again)
    torch.cuda.synchronize(dev)
    # an operator that only allocates (empty*) leaves bytes nothing wrote
    rows_g = [(op, [digest(x) for x in outs]) for op, outs, _ in in_graph.rows
              if ".empty" not in op]
    rows_e = [(op, [digest(x) for x in outs]) for op, outs, _ in eager.rows
              if ".empty" not in op]
    where_g = [(op, [list(x.shape) for x in outs], src)
               for op, outs, src in in_graph.rows if ".empty" not in op]
    where_e = [(op, [list(x.shape) for x in outs], src)
               for op, outs, src in eager.rows if ".empty" not in op]
    for i, (g, e) in enumerate(zip(rows_g, rows_e)):
        if g != e:
            return dict(index=i, of=len(rows_e),
                        same_operator=g[0] == e[0],
                        captured=where_g[max(0, i - 6):i + 4],
                        eager=where_e[max(0, i - 6):i + 4])
    return None if len(rows_g) == len(rows_e) else dict(
        note=f"{len(rows_g)} operators captured, {len(rows_e)} eager")


class Recorder:
    """Digests of one call: the IP carry before a solve's first trip and
    after each trip, the ADMM carry after each ADMM iteration, labelled by
    MPC step, ADMM iteration, solve and trip."""

    def __init__(self, graph_check=0):
        self.rows = []
        self.step = self.it = None
        self.solve = -1
        self.graph_check = graph_check    # solves left to check

    def where(self, trips=None):
        w = f"step {self.step} it {self.it}"
        if trips is None:
            return w + " ADMM carry"
        return w + f" {SOLVES[self.solve % 2]} solve trip {trips}"

    def on_trip(self, trip, carry, trips):
        if trips == 0:
            self.solve += 1
        where = self.where(trips)
        for name, x in tensors_of(carry):
            self.rows.append((where, name, digest(x)))
        if trips == 1 and self.graph_check > 0:
            self.graph_check -= 1
            print(json.dumps(dict(
                graph_vs_eager=self.where(trips),
                first_parting=graph_vs_eager(trip, carry))), flush=True)

    def on_admm(self, c):
        for name, x in tensors_of(c):
            self.rows.append((self.where(), name, digest(x)))


def install(rec):
    """Point the staged solver's trip hook and the planner's ADMM loop at
    ``rec``; returns the function that undoes it."""
    cls = ConsensusObcaPlanner
    mpc_step, admm = cls._mpc_step, cls._admm_iteration

    def mpc_step_rec(self, init_state, bs, step_idx):
        rec.step = int(step_idx)
        return mpc_step(self, init_state, bs, step_idx)

    def admm_rec(self, c, it, *a):
        rec.it, rec.solve = it, -1
        out = admm(self, c, it, *a)
        rec.on_admm(out)
        return out

    cls._mpc_step, cls._admm_iteration = mpc_step_rec, admm_rec
    ip_staged.on_trip = rec.on_trip

    def undo():
        cls._mpc_step, cls._admm_iteration = mpc_step, admm
        ip_staged.on_trip = None
    return undo


def first_parting(a, b):
    """Where the digest rows ``b`` first part from ``a``: (where, the
    tensors that differ there) or None."""
    for ra, rb in zip(a, b):
        if ra[:2] != rb[:2]:
            return dict(where=ra[0], other_path=rb[0],
                        note="the calls took different paths")
        if ra[2] != rb[2]:
            names = [x[1] for x in a if x[0] == ra[0]]
            da = {x[1]: x[2] for x in a if x[0] == ra[0]}
            db = {x[1]: x[2] for x in b if x[0] == ra[0]}
            return dict(where=ra[0],
                        tensors=[n for n in names if da[n] != db.get(n)])
    if len(a) != len(b):
        return dict(where=(a if len(a) > len(b) else b)[min(len(a),
                                                            len(b))][0],
                    note=f"one call has more rows ({len(a)} against "
                         f"{len(b)})")
    return None


def poison_allocator(dev):
    """Release the caching allocator's free memory, then fill new blocks of
    every size class with 0xff bytes (NaN in float32 and float64) and free
    them into the cache, so that memory handed out again and read before it
    is written reads NaN."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    keep = [torch.full((n,), 255, dtype=torch.uint8, device=dev)
            for n in [512 << i for i in range(12)] * 32]     # 512 B .. 1 MiB
    keep += [torch.full((n << 20,), 255, dtype=torch.uint8, device=dev)
             for n in (2, 4, 8, 16, 32, 64) * 4]
    torch.cuda.synchronize(dev)
    del keep


def load_carry(data, k, dev):
    fields = {n[len(f"{k}_"):]: data[n] for n in data.files
              if n.startswith(f"{k}_") and n != f"{k}_state"}
    return (torch.as_tensor(data[f"{k}_state"], device=dev),
            bar_state_from_numpy(fields, dtype=torch.float32, device=dev))


def run_step(pl, data, k, dev, label):
    st, bs = load_carry(data, k, dev)
    t0 = time.perf_counter()
    out = pl._mpc_step(st, bs, k)
    if dev == "cuda":
        torch.cuda.synchronize()
    print(f"{label} step {k}: ADMM iterations {out[2]} (the carries' "
          f"run: {int(data['iterations'][k])}), primal {float(out[3]):.4f}, "
          f"dual {float(out[4]):.4f}, nlp_ok {out[6].tolist()}, nlp_kkt "
          f"{out[7].tolist()}, {time.perf_counter() - t0:.1f} s", flush=True)
    return out


RECORD_FIELDS = ("iterations", "primal", "dual", "nlp_ok", "nlp_kkt", "gap",
                 "next_state", "local_x")


def record_steps(data, steps, dev, path, plain=False):
    """Each step once from its carry; writes ``port_<k>_<field>``."""
    keep = ip_staged.block_thomas_solve
    if plain:
        ip_staged.block_thomas_solve = chip_smoke.plain_solve(thomas,
                                                              ip_staged)
    arrays = {}
    try:
        pl = ConsensusObcaPlanner(device=dev,
                                  **chip_smoke.flagship_profile(torch.float32))
        for k in steps:
            if f"{k}_state" not in data.files:
                continue
            st, bs, it, pr, du, _cv, ok, kkt, gap = run_step(
                pl, data, k, dev, "plain" if plain else "kernel")
            rec = dict(iterations=np.asarray(int(it)), primal=pr, dual=du,
                       nlp_ok=ok, nlp_kkt=kkt, gap=gap, next_state=st,
                       local_x=bs.local_x)
            for f in RECORD_FIELDS:
                arrays[f"port_{k}_{f}"] = np.asarray(
                    rec[f].cpu().numpy() if torch.is_tensor(rec[f])
                    else rec[f])
            np.savez_compressed(path, device=np.asarray(dev),
                                plain=np.asarray(plain), **arrays)
    finally:
        ip_staged.block_thomas_solve = keep


def step_list(text):
    """``"10-30"`` or ``"14,17,20"`` -> step indices in order."""
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


def run_slice(dev):
    """The float32 slice of ``chip_smoke.py``: the first 6 MPC steps."""
    res = run_obca(Formulation.CONSENSUS, n_steps=chip_smoke.SMOKE_STEPS,
                   device=dev, **chip_smoke.flagship_profile(torch.float32))
    return res.states, list(res.metrics.iter_history)


def one_call(what, data, dev, graph_check=0):
    """Run ``what`` (``"slice"`` or a window step) once under a recorder:
    its digest rows, ADMM iterations and final state."""
    rec = Recorder(graph_check)
    undo = install(rec)
    try:
        if what == "slice":
            states, its = run_slice(dev)
            final = states[-1]
        else:
            pl = ConsensusObcaPlanner(
                device=dev, **chip_smoke.flagship_profile(torch.float32))
            out = run_step(pl, data, what, dev, "recorded")
            its, final = [int(out[2])], out[0].cpu().numpy()
    finally:
        undo()
    return dict(what=what, iterations=its, final_state=final.tolist(),
                final_digest=hashlib.sha1(
                    np.ascontiguousarray(final).tobytes()).hexdigest()[:16],
                rows=rec.rows)


def repeat(args, data, dev):
    """Every job (``--slice``, ``--steps``) ``--repeat`` times in this
    process; reports the first parting of each later call from the first.
    Returns {job: [call records]}."""
    jobs = (["slice"] if args.slice else []) + args.step_list
    out = {}
    for job in jobs:
        calls = []
        for n in range(args.repeat):
            if args.poison and dev == "cuda":
                poison_allocator(dev)
            t0 = time.perf_counter()
            call = one_call(job, data, dev,
                            args.graph_check if not calls else 0)
            call["seconds"] = time.perf_counter() - t0
            calls.append(call)
            line = dict(job=job, call=n, iterations=call["iterations"],
                        final_digest=call["final_digest"],
                        trips_recorded=len(call["rows"]),
                        seconds=round(call["seconds"], 1))
            if n:
                line["parts_from_call_0"] = first_parting(calls[0]["rows"],
                                                          call["rows"])
            print(json.dumps(line), flush=True)
        out[str(job)] = calls
    return out


def fresh(args, mine):
    """Run this tool's ``--repeat`` jobs once in ``--fresh`` new processes
    and compare each one's call with this process's first call."""
    flags = [a for a in sys.argv[1:]]
    for opt in ("--fresh", "--json", "--repeat"):
        while opt in flags:
            i = flags.index(opt)
            del flags[i:i + 2]
    for n in range(args.fresh):
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT)) as tmp:
            path = os.path.join(tmp, "calls.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), *flags,
                            "--repeat", "1", "--json", path], check=True)
            with open(path) as f:
                theirs = json.load(f)["calls"]
        for job, calls in theirs.items():
            rows = [tuple(r) for r in calls[0]["rows"]]
            first = [tuple(r) for r in mine[job][0]["rows"]]
            print(json.dumps(dict(
                job=job, fresh_process=n, iterations=calls[0]["iterations"],
                final_digest=calls[0]["final_digest"],
                parts_from_this_process_call_0=first_parting(first, rows))),
                flush=True)


def kkt_check(data, k, iters, every, dev):
    keep = ip_staged.block_thomas_solve
    systems, calls = [], [0]

    def sample(d, u, r):
        out = keep(d, u, r)
        calls[0] += 1
        if calls[0] % every == 0:
            systems.append((d.clone(), u.clone(), r.clone(), out.clone()))
        return out

    pl = ConsensusObcaPlanner(device=dev, **chip_smoke.flagship_profile(
        torch.float32, max_admm_iters=iters))
    ip_staged.block_thomas_solve = sample
    try:
        run_step(pl, data, k, dev, "eager, sampling")
    finally:
        ip_staged.block_thomas_solve = keep
    res = {"warp": [], "wide": [], "plain": []}
    for d, u, r, out in systems:
        a, rr = chip_smoke.dense_system(d.double(), u.double(), r.double())
        sols = dict(warp=out,
                    wide=thomas.launch_kernel(d, u, r, True, kernel="wide"),
                    plain=thomas.block_thomas_plain(d, u, r, True))
        for name, x in sols.items():
            xs = x.double().reshape(rr.shape)
            v = (a @ xs - rr).abs().amax((1, 2)) / (1.0 + rr.abs().amax((1, 2)))
            res[name].append(float(torch.nan_to_num(v, nan=float("inf")).max()))
    print(f"step {k}: {calls[0]} block solves, {len(systems)} sampled")
    for name, v in res.items():
        v = np.asarray(v)
        print(f"  {name}: residual median {np.median(v):.3e}, 90 % "
              f"{np.quantile(v, 0.9):.3e}, max {v.max():.3e}; "
              f"{int((v > 1e-4).sum())} of {len(v)} above 1e-4")
    w, p = np.asarray(res["warp"]), np.asarray(res["plain"])
    print(f"  warp more than 10 times the plain version's residual (and "
          f"above 1e-5): {int(((w > 10 * p) & (w > 1e-5)).sum())}; the "
          f"other way: {int(((p > 10 * w) & (p > 1e-5)).sum())}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--carries", default=None)
    ap.add_argument("--steps", default="")
    ap.add_argument("--slice", action="store_true")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--poison", action="store_true")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--graph-check", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--eager", type=int, default=0)
    ap.add_argument("--kkt-step", type=int, default=None)
    ap.add_argument("--kkt-iters", type=int, default=45)
    ap.add_argument("--every", type=int, default=30)
    ap.add_argument("--record", default=None)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    dev = args.device
    data = np.load(args.carries or default_carries())
    args.step_list = step_list(args.steps)
    if args.record:
        record_steps(data, args.step_list, dev, args.record, args.plain)
        if dev == "cuda":
            print(chip_smoke.nvidia_smi())
        return
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    if args.repeat:
        calls = repeat(args, data, dev)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(calls=calls, argv=sys.argv[1:]), f)
        if args.fresh:
            fresh(args, calls)
    else:
        pl = ConsensusObcaPlanner(device=dev,
                                  **chip_smoke.flagship_profile(torch.float32))
        path = "graphed" if dev == "cuda" else "eager"
        for k in args.step_list:
            run_step(pl, data, k, dev, path)
            run_step(pl, data, k, dev, path + ", again")
    if not (args.eager or args.kkt_step is not None):
        if dev == "cuda":
            print(chip_smoke.nvidia_smi())
        return
    graphed = ip_staged._trips_graphed
    ip_staged._trips_graphed = ip_staged._trips_eager
    try:
        if dev == "cuda":
            for k in args.step_list[:args.eager]:
                run_step(ConsensusObcaPlanner(
                    device=dev, **chip_smoke.flagship_profile(torch.float32)),
                    data, k, dev, "eager")
        if args.kkt_step is not None:
            if dev != "cuda":
                raise RuntimeError("--kkt-step compares CUDA kernels: it "
                                   "needs --device cuda")
            kkt_check(data, args.kkt_step, args.kkt_iters, args.every, dev)
    finally:
        ip_staged._trips_graphed = graphed
    if dev == "cuda":
        print(chip_smoke.nvidia_smi())


if __name__ == "__main__":
    main()
