"""Where the time of one ``BinaryFluidSim`` step goes on the card.

    python3 tools/profile_lb_step.py [--grid 128] [--steps 10]

For each regime (unfused, ``one_launch``, ``two_launch``) it runs
``BinaryFluidSim.run`` once to warm up, then traces ``--steps`` steps with
``torch.profiler`` and reports, per regime: the host wall time per step
(ending in ``torch.cuda.synchronize()``), the device time per step summed
over kernels, the device's busy share of the traced span, and the device
time per kernel name, split into the port's own CUDA kernels and PyTorch's
(the gather/pad prologue and copies).  Needs one CUDA card; writes the full
table to ``chiprun_out/profile_lb_step.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_KERNELS = ("gathered_kernel", "windowed_kernel", "lb_collision_kernel")


def profile_regime(sim, state, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    sim.run(state, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(state, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0.0
    port_us = sum(v for k, v in by_name.items()
                  if any(p in k for p in PORT_KERNELS))
    return {
        "steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": busy_us / steps / 1e3,
        "port_kernels_ms_per_step": port_us / steps / 1e3,
        "torch_ops_ms_per_step": (busy_us - port_us) / steps / 1e3,
        "device_busy_share_of_span": busy_us / span_us if span_us else None,
        "device_busy_share_of_wall": busy_us / 1e6 / wall,
        "kernels_traced": len(kernels),
        "by_kernel_ms_per_step": {
            k: v / steps / 1e3
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lb_step: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim

    grid = (args.grid,) * 3
    params = LBParams(A=0.125, B=0.125, kappa=0.02)
    out = {"device": torch.cuda.get_device_name(0), "grid": grid,
           "regimes": {}}
    state = None
    for regime in (False, "one_launch", "two_launch"):
        sim = BinaryFluidSim(grid, params, fused=regime)
        if state is None:
            state = sim.init_spinodal(seed=0, noise=0.05)
        row = profile_regime(sim, state, args.steps)
        out["regimes"][str(regime)] = row
        top = dict(list(row["by_kernel_ms_per_step"].items())[:6])
        print(json.dumps({"regime": str(regime), **{
            k: v for k, v in row.items() if k != "by_kernel_ms_per_step"},
            "top_kernels_ms_per_step": top}), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_lb_step.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
