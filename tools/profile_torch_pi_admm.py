"""Profile the PI-ADMM fused trip of the PyTorch port on one CUDA card.

Builds ``bench.py``'s first-metric engine (16 vehicles, horizon 30, 24 pairs
a lane, per-step cap 60, whole-run budget 210) in float32 (or float64) on
the bench's 32 seeded starts (``tests/data/pi_admm_bench_f32_ref.npz``),
runs one warm-up ``run_fused_batch``, advances a fresh fused carry by
``--skip`` trips into the conflict window, and then, from there:

* ``eager``: ``--trips`` trips dispatched one by one under
  ``torch.profiler`` (CPU and CUDA activities);
* ``graph``: the trip captured once as a CUDA graph (as
  ``run_fused_batch`` does) and replayed ``--trips`` times under the
  profiler, and again between two CUDA events without it.

For each it prints the kernels per trip, the device time per trip (the sum
of the kernels' durations), the wall per trip (host clock around the trips,
synchronized), the device busy share (device time over wall; one stream, so
kernels do not overlap) and the five operations (``key_averages``) that take
the most device time; ``nvidia-smi``'s name and power limit; and one JSON
line with all of it (also written to ``--out``).

Usage: python3 tools/profile_torch_pi_admm.py [--dtype f32|f64] [--skip N]
           [--trips N] [--out PATH.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "data", "pi_admm_bench_f32_ref.npz")


def bench_engine(prof, dtype):
    from dlp_admm_torch.config import (DualUpdateConfig, PiAdmmConfig,
                                       SolverConfig)
    from dlp_admm_torch.models.pi_admm import PiAdmmEngine
    from dlp_admm_torch.scenarios import pi_admm_overtake_refs
    v = prof["num_veh"]
    cfg = PiAdmmConfig(num_veh=v, horizon=prof["horizon"],
                       speeds=tuple(8.0 if i % 2 == 0 else 4.0
                                    for i in range(v)),
                       iter_num=prof["iter_cap"], **prof["cfg"])
    refs, _ = pi_admm_overtake_refs(cfg)
    return PiAdmmEngine(cfg, DualUpdateConfig(**prof["dual"]),
                        SolverConfig(**prof["solver"]), refs=refs,
                        dtype=dtype, device="cuda", **prof["engine"])


def _device_us(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profiled(run, trips):
    """Run ``run()`` (``trips`` trips) under the profiler; returns the
    numbers per trip and the top five operations by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=_device_us, reverse=True)
    total = sum(_device_us(e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) or dev_us
    top = [dict(name=e.key, device_ms=_device_us(e) / 1e3,
                calls=e.count, share=_device_us(e) / total if total else 0.0)
           for e in ops if _device_us(e) > 0][:5]
    kern = sorted(prof.key_averages(), key=_device_us, reverse=True)
    top_kernels = [dict(name=e.key[:80], device_ms=_device_us(e) / 1e3,
                        calls=e.count) for e in kern
                   if e.device_type == torch.autograd.DeviceType.CUDA][:5]
    return dict(trips=trips, kernels_per_trip=len(kernels) / trips,
                device_ms_per_trip=dev_us / 1e3 / trips,
                wall_ms_per_trip=1e3 * wall / trips,
                busy_share=(dev_us / 1e6) / wall if wall else 0.0,
                idle_share=1.0 - (dev_us / 1e6) / wall if wall else 0.0,
                top_ops=top, top_kernels=top_kernels)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--skip", type=int, default=40,
                    help="trips before the profiled window")
    ap.add_argument("--trips", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("this profile needs a CUDA card")
    import dlp_admm_torch  # noqa: F401  (TF32 off)
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    ref = np.load(FIXTURE)
    prof = json.loads(str(ref["profile"]))
    xts = ref["xts0"].astype(np.float32 if args.dtype == "f32"
                             else np.float64)
    eng = bench_engine(prof, dtype)
    n_steps, budget = prof["n_steps"], prof["iter_budget"]
    us = np.zeros(xts.shape[:2] + (prof["horizon"],), xts.dtype)
    eng.run_fused_batch(xts, us, n_steps, budget)          # warm-up
    torch.cuda.synchronize()

    def trip(c):
        return eng._fused_trip(c, n_steps, budget)

    carry = eng._fused_carry0(xts, us, n_steps)
    for _ in range(args.skip):
        carry = trip(carry)
    live = int((carry["k"] < n_steps).sum())
    state = {"c": carry}

    def eager():
        for _ in range(args.trips):
            state["c"] = trip(state["c"])

    out = dict(dtype=args.dtype, lanes=int(xts.shape[0]), skip=args.skip,
               live_lanes_at_window=live)
    out["eager"] = profiled(eager, args.trips)
    graph, _ = eng._capture_trip(trip, carry)
    out["graph"] = profiled(lambda: [graph.replay()
                                     for _ in range(args.trips)], args.trips)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(args.trips):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    out["graph_event_ms_per_trip"] = start.elapsed_time(end) / args.trips
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for mode in ("eager", "graph"):
        r = out[mode]
        print(f"{mode}: {r['kernels_per_trip']:.0f} kernels a trip, device "
              f"{r['device_ms_per_trip']:.3f} ms, wall "
              f"{r['wall_ms_per_trip']:.3f} ms a trip, busy "
              f"{r['busy_share']:.3f}")
        for op in r["top_ops"]:
            print("   ", json.dumps(op))
    print(f"graph replay between CUDA events: "
          f"{out['graph_event_ms_per_trip']:.3f} ms a trip")
    print(out["nvidia_smi"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
