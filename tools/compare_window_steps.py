"""Set single MPC steps of the port beside JAX's from the same carries and
ask whether the port's steps lean one way.

Inputs are ``.npz`` files of ``tools/check_torch_window.py --record``
(``port_<k>_<field>``; the port on the card, on the card with ``--plain``,
or on the CPU) and of ``tools/jax_window_steps.py --noise EPS``
(``jax_<k>_<field>`` and ``jax_moved_<k>_<field>``), all from one carries
file of ``tools/perturbed_torch_flagship.py --carries``.

For each step ``k`` and metric ``m`` (ADMM iterations, primal and dual
residuals, consensus gap, the smallest centre distance of the next carry's
planned states), the signed error of a side is
``m_side(k) - m_jax(k)``, and JAX's own noise floor is ``m_moved(k) -
m_jax(k)``. A side is biased on a metric if its steps are farther from
JAX's than JAX-moved's are (one-sided Wilcoxon on ``|e_side| - |e_moved|``)
and lean one way (two-sided sign test on ``e_side``), both p < 0.05. Chaos
alone moves a step as far as the noise does, and in no one direction.
With JAX's ``--then`` steps in the file, the next step is also compared
from both carries: JAX's step ``k + 1`` from the side's carry ``k + 1``
against JAX's step ``k + 1`` from its own step ``k``'s carry (``next``:
whether the side leaves carries that are harder to step from).
Capping is compared pair by pair: the steps the side caps and JAX does not
against the other way round (an exact McNemar test, two-sided). ``--pool``
adds the same over every side's steps together, for runs of one kind (the
10 card runs' windows: 210 pairs).

A whole run of ``tools/perturbed_torch_flagship.py --carries`` is a side
too (``--run NAME=RUN.json,CARRIES.npz``): a step is a pure function of its
carry, so the run's own step ``k`` is the step from carry ``k``; its records
give the iterations and residuals and carry ``k + 1`` the next state and
plan. That way the card's side costs no call of its own.

Usage: python3 tools/compare_window_steps.py --jax J.npz [--jax ...]
           [--side NAME=PATH.npz[+PATH.npz...] ...]
           [--run NAME=RUN.json,CARRIES.npz ...] [--pool] [--json PATH]

(one ``--jax`` file per side, in the order of the ``--side`` then the
``--run`` arguments)
"""
import argparse
import json
import re

import numpy as np

METRICS = ("iterations", "primal", "dual", "gap", "plan_min_distance_m")
ADMM_CAP = 50
ALPHA = 0.05


def steps_of(data, prefix):
    pat = re.compile(rf"^{prefix}_(\d+)_iterations$")
    return sorted(int(m.group(1)) for f in data.files
                  if (m := pat.match(f)))


def metrics(data, prefix, k):
    def get(f):
        return np.asarray(data[f"{prefix}_{k}_{f}"], dtype=np.float64)
    nxt = get("next_state")
    plan = get("local_x")
    return dict(
        iterations=float(get("iterations")), primal=float(get("primal")),
        dual=float(get("dual")), gap=float(get("gap")),
        next_distance_m=float(np.linalg.norm(nxt[0, :2] - nxt[1, :2])),
        plan_min_distance_m=float(np.linalg.norm(
            plan[0, :, :2] - plan[1, :, :2], axis=-1).min()),
        capped=bool(get("iterations") >= ADMM_CAP),
        nlp_ok=get("nlp_ok").tolist())


def capping(rows):
    """Steps the side caps and JAX does not, the other way, and the exact
    two-sided McNemar p of that split."""
    from scipy.stats import binomtest
    only_side = sum(r["side"]["capped"] and not r["jax"]["capped"]
                    for r in rows)
    only_jax = sum(r["jax"]["capped"] and not r["side"]["capped"]
                   for r in rows)
    n = only_side + only_jax
    return dict(side=sum(r["side"]["capped"] for r in rows),
                jax=sum(r["jax"]["capped"] for r in rows),
                moved=sum(r["moved"]["capped"] for r in rows),
                only_side=only_side, only_jax=only_jax,
                p=float(binomtest(only_side, n).pvalue) if n else 1.0)


def summarize(name, rows):
    summary = {}
    for m in METRICS:
        e_side = [r["side"][m] - r["jax"][m] for r in rows]
        e_moved = [r["moved"][m] - r["jax"][m] for r in rows]
        summary[m] = s = lean(e_side, e_moved)
        print(f"  {m}: median |side - JAX| {s['median_abs_side']:.4g}"
              f" against the noise's {s['median_abs_moved']:.4g}; "
              f"side above JAX {s['positive']}, below {s['negative']}; "
              f"p farther {s['p_farther_than_noise']:.3g}, p one way "
              f"{s['p_one_way']:.3g}" + ("  BIASED" if s["biased"] else ""))
    cap = capping(rows)
    print(f"  steps at the ADMM cap: side {cap['side']}, JAX {cap['jax']}, "
          f"JAX moved {cap['moved']}; only the side {cap['only_side']}, only"
          f" JAX {cap['only_jax']} (p {cap['p']:.3g})")
    return dict(rows=rows, summary=summary, capped=cap)


def side_from_run(run_path, carries_path):
    """``port_<k>_<field>`` arrays of every step of a whole run, from its
    record and its carries."""
    with open(run_path) as f:
        run = json.load(f)["runs"][0]
    car = np.load(carries_path)
    out = {}
    for k, (it, row) in enumerate(zip(run["iterations"],
                                      run["residual_rows"])):
        if f"{k + 1}_state" not in car.files:
            break
        pr, du, ok0, ok1, kk0, kk1, gap = row
        out.update({f"port_{k}_iterations": np.asarray(it),
                    f"port_{k}_primal": np.asarray(pr),
                    f"port_{k}_dual": np.asarray(du),
                    f"port_{k}_nlp_ok": np.asarray([ok0, ok1]),
                    f"port_{k}_nlp_kkt": np.asarray([kk0, kk1]),
                    f"port_{k}_gap": np.asarray(gap),
                    f"port_{k}_next_state": car[f"{k + 1}_state"],
                    f"port_{k}_local_x": car[f"{k + 1}_local_x"]})
    return _Arrays(out)


class _Arrays(dict):
    """A dict with the ``files`` attribute of a loaded ``.npz``."""

    @property
    def files(self):
        return list(self)


def lean(e_side, e_moved):
    """p-values: farther than the noise floor, and leaning one way."""
    from scipy.stats import binomtest, wilcoxon
    e_side, e_moved = np.asarray(e_side), np.asarray(e_moved)
    d = np.abs(e_side) - np.abs(e_moved)
    p_far = (float(wilcoxon(d, alternative="greater").pvalue)
             if np.any(d != 0) else 1.0)
    nz = e_side[e_side != 0]
    pos = int((nz > 0).sum())
    p_sign = float(binomtest(pos, len(nz)).pvalue) if len(nz) else 1.0
    return dict(median_abs_side=float(np.median(np.abs(e_side))),
                median_abs_moved=float(np.median(np.abs(e_moved))),
                median_side=float(np.median(e_side)),
                positive=pos, negative=int((nz < 0).sum()),
                p_farther_than_noise=p_far, p_one_way=p_sign,
                biased=bool(p_far < ALPHA and p_sign < ALPHA))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", required=True, action="append",
                    help="one per side, in the order of --side then --run")
    ap.add_argument("--side", action="append", default=[],
                    help="NAME=PATH.npz[+PATH.npz...] of "
                         "check_torch_window.py --record")
    ap.add_argument("--run", action="append", default=[],
                    help="NAME=RUN.json,CARRIES.npz of a whole run")
    ap.add_argument("--pool", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = {}
    sides = [(n, lambda p=p: _Arrays({k: v for q in p.split("+")
                                      for k, v in np.load(q).items()}))
             for n, p in (x.split("=", 1) for x in args.side)]
    sides += [(n, lambda p=p: side_from_run(*p.split(",")))
              for n, p in (x.split("=", 1) for x in args.run)]
    if len(args.jax) != len(sides):
        raise SystemExit("give one --jax file per side")
    for (name, load), jpath in zip(sides, args.jax):
        sd, jx = load(), np.load(jpath)
        ks = [k for k in steps_of(sd, "port")
              if k in steps_of(jx, "jax") and k in steps_of(jx, "jax_moved")]
        rows = []
        for k in ks:
            rows.append(dict(step=k, side=metrics(sd, "port", k),
                             jax=metrics(jx, "jax", k),
                             moved=metrics(jx, "jax_moved", k)))
        print(f"{name}: steps {ks[0]}-{ks[-1]} ({len(ks)})" if ks
              else f"{name}: no common steps")
        print("  step: ADMM iterations side / JAX / JAX moved; plan min "
              "distance m side / JAX / moved")
        for r in rows:
            print(f"  {r['step']}: {r['side']['iterations']:.0f} / "
                  f"{r['jax']['iterations']:.0f} / "
                  f"{r['moved']['iterations']:.0f}; "
                  f"{r['side']['plan_min_distance_m']:.4f} / "
                  f"{r['jax']['plan_min_distance_m']:.4f} / "
                  f"{r['moved']['plan_min_distance_m']:.4f}")
        out[name] = summarize(name, rows) if rows else dict(rows=[])
        nxt = [dict(step=k, side=metrics(jx, "jax", k),
                    jax=metrics(jx, "jax_then", k),
                    moved=metrics(jx, "jax_moved", k))
               for k in steps_of(jx, "jax_then") if k in steps_of(jx, "jax")
               and k in steps_of(jx, "jax_moved")]
        if nxt:
            print(f"  next: JAX's step from the side's carry against JAX's "
                  f"step from its own ({len(nxt)} steps)")
            out[name]["next"] = summarize(name + " next", nxt)
    if args.pool and len(out) > 1:
        rows = [r for v in out.values() for r in v["rows"]]
        print(f"pooled: {len(rows)} steps of {len(out)} sides")
        pooled = summarize("pooled", rows)
        nxt = [r for v in out.values() for r in v.get("next", {}).get(
            "rows", [])]
        if nxt:
            print(f"pooled next: {len(nxt)} steps")
            pooled["next"] = summarize("pooled next", nxt)
        out["pooled"] = pooled
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
