"""Judge the port's float32 PI-ADMM bench runs against JAX's over shared
starts (``PERF.md`` §6, ``ROADMAP.md``'s kept differences).

``bench.py``'s first metric gates one run on ``converged >= 0.93`` (at most
26 of the 384 lane-steps at the ADMM cap). Under start noise of 1e-6 both
sides spread over several times that margin, so one run says little. The
rule, written before the runs: the port is at fault if its runs cap more
lanes than JAX's from the same starts with a one-sided Mann-Whitney
p < 0.05.

Inputs: ``--port PATH``, the JSON lines of ``tools/perturbed_torch_pi_admm.py
--noise 1e-6 --seeds ...`` (the unmoved run is left out); ``--jax PATH ...``,
the outputs of ``tools/make_torch_fixture.py --profile pi_admm_f32 --noise
1e-6 --seed N`` (the last JSON line of each). Only seeds on both sides are
judged. Plain numpy and scipy: runs on the CPU.

Usage: python3 tools/judge_pi_admm_f32.py --port port.jsonl
           --jax jax_seed1.log jax_seed2.log ... [--json PATH]
"""
import argparse
import json

ALPHA = 0.05
LANE_STEPS = 32 * 12         # bench.py's 32 lanes x 12 MPC steps
GATE = 0.93                  # bench.py:33, converged fraction


def last_json(path):
    """The last line of a file that parses as a JSON object."""
    with open(path) as f:
        lines = [ln for ln in f if ln.lstrip().startswith("{")]
    return json.loads(lines[-1])


def port_runs(path):
    """seed -> capped lane-steps of the port's moved runs."""
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.lstrip().startswith("{")]
    return {r["seed"]: r["capped"] for r in rows if r.get("seed") is not None}


def below_gate(caps):
    """Runs whose converged fraction misses the gate."""
    return sum(1 - c / LANE_STEPS < GATE for c in caps)


def judge(port, jax):
    """One-sided Mann-Whitney p that the port caps more lanes than JAX."""
    from scipy.stats import mannwhitneyu
    p = float(mannwhitneyu(port, jax, alternative="greater",
                           method="asymptotic").pvalue)
    return dict(p_port_caps_more=p, fault=p < ALPHA)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", required=True)
    ap.add_argument("--jax", nargs="+", required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    port = port_runs(args.port)
    jax = {}
    for path in args.jax:
        r = last_json(path)
        jax[r["seed"]] = r["capped"]
    seeds = sorted(set(port) & set(jax))
    p_cap = [port[s] for s in seeds]
    j_cap = [jax[s] for s in seeds]
    out = dict(seeds=seeds, port_capped=p_cap, jax_capped=j_cap,
               port_below_gate=below_gate(p_cap),
               jax_below_gate=below_gate(j_cap),
               **judge(p_cap, j_cap))
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
