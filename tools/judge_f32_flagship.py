"""Judge the port's float32 flagship runs against JAX's over shared starts.

The 42-step float32 consensus-OBCA run is chaotic in its conflict window,
so one run says little: a rounding-level change of the start moves res_ok
by several steps in JAX itself. This tool sets two groups of runs from the
same starts side by side and applies the rule of PERF.md §6: a side
is lower than JAX if a one-sided Mann-Whitney test gives p < 0.05 on res_ok
or on the minimum centre distance.

Inputs:

* ``--port PATH.json ...``: records of ``tools/perturbed_torch_flagship.py
  --out`` (on the card or, with ``--device cpu``, on the CPU);
* ``--jax PATH.npz ...``: JAX runs written by ``tools/make_torch_fixture.py
  --profile f32 [--noise 1e-7 --seed N] --out PATH.npz``; the unmoved JAX
  run is the committed ``tests/data/consensus_obca_f32_ref.npz``;
* or ``--shared-starts``: the 17 shared starts of ``PERF.md`` §6 (the
  unmoved start and seeds 1-16 at 1e-7), JAX's float32 runs on the CPU and
  the port's on the card (NVIDIA H100 80GB HBM3, 700.00 W), as recorded
  there: the given runs are judged against JAX's on the first 11 and on
  all 17, and set against the card's by a two-sided test (is a stand-in's
  side apart from the card's?);
* or ``--stage-f64 PATH.npz ...``: JAX's float32 runs from the 17 shared
  starts with every KKT solve of its staged solver in float64
  (``tools/make_torch_fixture.py --profile f32 --stage-f64 [--noise 1e-7
  --seed N] --out .../<label>.npz``, the label ``unmoved`` or ``seedN``
  after the file name's last ``_``), judged by Rule J of ``PERF.md`` §6:
  J-up if a one-sided Mann-Whitney test finds them higher on
  res_ok than JAX's float32 runs with p < 0.05, J-flat otherwise; beside
  it, two-sided, against the card's float64-K1 runs.

Prints a table row per run (res_ok, steps at the ADMM cap, minimum centre
distance, minimum footprint gap, NLP health, median and maximum consensus
gap), each side's median, and the two p-values; ``--json`` keeps them.
Plain numpy and scipy: runs on the CPU.

Usage: python3 tools/judge_f32_flagship.py --port A.json [B.json ...]
           (--jax X.npz [Y.npz ...] | --shared-starts) [--name card]
           [--json PATH]
       python3 tools/judge_f32_flagship.py --stage-f64 X.npz [...]
           [--json PATH]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dlp_admm_torch.ops.geometry import vehicle_vertices  # noqa: E402

ADMM_CAP = 50
RES_TOL = 0.011          # bench.py:224
ALPHA = 0.05
COLUMNS = ("res_ok", "steps_at_cap", "min_distance_m", "min_footprint_gap_m",
           "health", "gap_median", "gap_max")
# the 17 shared starts of PERF.md §6 (unmoved, seeds 1-16 at 1e-7): res_ok
# and minimum centre distance per start, JAX on the CPU and the card (and
# the card with every float32 KKT solve through K1's float64 equilibrated
# variant, perturbed_torch_flagship.py --k1-f64, and JAX with every KKT
# solve of its staged solver in float64, make_torch_fixture.py --stage-f64)
SHARED_LABELS = ("unmoved",) + tuple(f"seed{i}" for i in range(1, 17))
SHARED_STARTS = dict(
    jax=dict(res_ok=(39, 40, 41, 32, 34, 39, 39, 40, 40, 39, 41, 35, 37, 41,
                     41, 33, 41),
             min_distance_m=(4.050, 3.761, 4.206, 3.764, 3.269, 4.321, 3.381,
                             4.295, 4.010, 3.640, 4.292, 3.231, 3.323, 3.398,
                             3.355, 2.937, 3.728)),
    card=dict(res_ok=(33, 37, 38, 40, 39, 33, 38, 37, 34, 37, 39, 42, 39, 37,
                      41, 34, 36),
              min_distance_m=(3.128, 4.151, 4.171, 3.992, 4.013, 3.111,
                              3.960, 2.926, 3.068, 3.686, 3.273, 2.618,
                              4.079, 3.751, 4.110, 2.940, 3.530)),
    card_k1_f64=dict(res_ok=(39, 38, 40, 41, 36, 41, 39, 39, 41, 37, 41, 32,
                             41, 37, 40, 37, 41),
                     min_distance_m=(4.159, 3.440, 3.581, 4.112, 2.728, 4.069,
                                     4.144, 3.789, 4.637, 3.206, 3.465, 2.367,
                                     4.495, 3.567, 4.234, 3.341, 4.614)),
    jax_stage_f64=dict(res_ok=(39, 41, 40, 29, 36, 38, 40, 35, 39, 34, 34,
                               33, 39, 37, 38, 41, 40),
                       min_distance_m=(4.318, 3.823, 4.187, 2.167, 2.861,
                                       2.647, 2.768, 2.710, 3.104, 2.591,
                                       2.492, 2.642, 3.953, 4.671, 4.306,
                                       3.968, 4.430)))


def footprint_gap(states):
    """The smallest distance between the two vehicles' footprints over a
    run's states ``[n+1, 2, 5]``."""
    corners = vehicle_vertices(torch.as_tensor(
        np.asarray(states), dtype=torch.float64)).numpy()
    return float(min(chip_smoke.polygon_gap(c[0], c[1]) for c in corners))


def jax_record(path):
    """One JAX run's row from its ``.npz``."""
    d = np.load(path)
    its = np.asarray(d["iterations"])
    p = np.asarray(d["states"])[..., :2]
    res_ok = (np.asarray(d["primal"]) <= RES_TOL) & (
        np.asarray(d["dual"]) <= RES_TOL)
    label = os.path.splitext(os.path.basename(path))[0]
    return dict(label=label, res_ok=int(res_ok.sum()),
                steps_at_cap=int((its >= ADMM_CAP).sum()),
                min_distance_m=float(np.linalg.norm(
                    p[:, 0] - p[:, 1], axis=-1).min()),
                min_footprint_gap_m=footprint_gap(d["states"]),
                health=float(np.mean(np.asarray(d["nlp_ok"]) == 1.0)),
                gap_median=float(np.median(d["gaps"])),
                gap_max=float(np.max(d["gaps"])))


def port_records(path):
    """The rows of one ``perturbed_torch_flagship.py --out`` file."""
    with open(path) as f:
        data = json.load(f)
    rows = []
    for r in data["runs"]:
        its = r["iterations"]
        rows.append(dict(
            label=r.get("label") or f"seed{r['seed']}",
            res_ok=r["res_ok"],
            steps_at_cap=r.get("steps_at_cap",
                               int(sum(i >= ADMM_CAP for i in its))),
            **{k: r[k] for k in COLUMNS[2:]}))
    return rows, data.get("nvidia_smi")


def mann_whitney_less(x, y):
    """One-sided p that ``x`` is lower than ``y`` (ties corrected)."""
    from scipy.stats import mannwhitneyu
    return float(mannwhitneyu(x, y, alternative="less",
                              method="asymptotic").pvalue)


def shared_rows(side):
    """One side of the 17 shared starts as rows (res_ok and distance)."""
    d = SHARED_STARTS[side]
    return [dict(label=lab, res_ok=r, min_distance_m=m)
            for lab, r, m in zip(SHARED_LABELS, d["res_ok"],
                                 d["min_distance_m"])]


def apart(a, b):
    """Two-sided Mann-Whitney p on res_ok and minimum centre distance."""
    from scipy.stats import mannwhitneyu
    return {f"p_{k}": float(mannwhitneyu(
        [r[k] for r in a], [r[k] for r in b], alternative="two-sided",
        method="asymptotic").pvalue) for k in ("res_ok", "min_distance_m")}


def against_shared(port):
    """The port's runs (labelled as the shared starts) against the shared
    starts' runs: by the rule against JAX on the first 11 starts and on all
    17, and two-sided against the card's."""
    by = {r["label"]: r for r in port}
    out = {}
    for n in (11, 17):
        labels = [lab for lab in SHARED_LABELS[:n] if lab in by]
        mine = [by[lab] for lab in labels]
        jax = [r for r in shared_rows("jax") if r["label"] in labels]
        card = [r for r in shared_rows("card") if r["label"] in labels]
        out[f"first_{n}"] = dict(n=len(mine), vs_jax=judge(mine, jax),
                                 vs_card=apart(mine, card))
    return out


def rule_j(j64):
    """Rule J on JAX's float64-stage runs ``j64`` (rows labelled as the
    shared starts): the one-sided p that JAX's float32 runs are lower on
    res_ok (J-up below ``ALPHA``), and two-sided against the card's
    float64-K1 runs of the same starts."""
    labels = {r["label"] for r in j64}
    j32, k1 = ([r for r in shared_rows(side) if r["label"] in labels]
               for side in ("jax", "card_k1_f64"))
    by = {r["label"]: r for r in j64}
    mine = [by[r["label"]] for r in j32]
    p_up = mann_whitney_less([r["res_ok"] for r in j32],
                             [r["res_ok"] for r in mine])
    return dict(n=len(mine), p_up=p_up,
                verdict="J-up" if p_up < ALPHA else "J-flat",
                vs_card_k1_f64=apart(mine, k1))


def judge(port, jax_rows):
    """The rule: p-values on res_ok and minimum centre distance, and
    whether either is below ``ALPHA``."""
    p = {k: mann_whitney_less([r[k] for r in port], [r[k] for r in jax_rows])
         for k in ("res_ok", "min_distance_m")}
    return dict(p_res_ok=p["res_ok"], p_min_distance=p["min_distance_m"],
                fault=bool(min(p.values()) < ALPHA))


def table(name, rows):
    print(f"{name}: " + " | ".join(("label",) + COLUMNS))
    for r in rows:
        print("  " + " | ".join([r["label"]] + [
            f"{r[k]:.4g}" if isinstance(r[k], float) else str(r[k])
            for k in COLUMNS]))
    med = {k: float(np.median([r[k] for r in rows])) for k in COLUMNS}
    print("  median: " + ", ".join(f"{k} {v:.4g}" for k, v in med.items()))
    return med


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", nargs="+", default=[])
    ap.add_argument("--jax", nargs="+", default=[])
    ap.add_argument("--shared-starts", action="store_true")
    ap.add_argument("--stage-f64", nargs="+", default=[])
    ap.add_argument("--name", default="port")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if args.stage_f64:
        rows = [dict(jax_record(p), label=os.path.splitext(
            os.path.basename(p))[0].split("_")[-1]) for p in args.stage_f64]
        out = dict(j64=rows, j64_median=table("JAX, float64 stage (CPU)",
                                              rows), rule_j=rule_j(rows))
        print(json.dumps(out["rule_j"]))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        return
    if not args.port or bool(args.jax) == args.shared_starts:
        ap.error("give --port with --jax files or --shared-starts")
    port, smi = [], set()
    for path in args.port:
        rows, s = port_records(path)
        port += rows
        smi.add(s)
    out = dict(port=port, device=sorted(x for x in smi if x),
               port_median=table(args.name, port))
    if args.shared_starts:
        out["shared_starts"] = against_shared(port)
        print(json.dumps(dict(n_port=len(port), device=out["device"],
                              **out["shared_starts"])))
    else:
        jax_rows = [jax_record(p) for p in args.jax]
        out.update(jax=jax_rows, jax_median=table("jax (CPU)", jax_rows))
        out.update(judge(port, jax_rows))
        print(json.dumps(dict(n_port=len(port), n_jax=len(jax_rows),
                              p_res_ok=out["p_res_ok"],
                              p_min_distance=out["p_min_distance"],
                              fault=out["fault"], device=out["device"])))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
