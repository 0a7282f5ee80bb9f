"""Where the time of one ``BinaryFluidSim`` step goes on the card.

    python3 tools/profile_lb_step.py [--grid 128] [--steps 10] [--src DIR]
                                     [--tag NAME] [--mesh 1x1x1 [--overlap]]

For each regime (unfused, ``one_launch``, ``two_launch``) it runs
``BinaryFluidSim.run`` once to warm up, times ``--steps`` steps three times
without the profiler (the median gives MLUPS and the unprofiled wall time
per step), then traces ``--steps`` steps with ``torch.profiler`` and
reports, per regime: the host wall time per step under the profiler
(ending in ``torch.cuda.synchronize()``), the device time per step summed
over kernels, the device's busy share of the traced span, and the device
time per kernel name, split into the port's own CUDA kernels and PyTorch's
(a gather or pad prologue, copies), and the number of PyTorch kernels per
step.  ``--src`` may point at another checkout's ``src`` (one unpacked with
``git archive``), so two versions compare within one call: run the script
once per version, in turns.  ``--mesh`` runs every regime decomposed over a
one-rank NCCL mesh (``1``, ``1x1``, ``1x1x1``: slab, pencil, block; a
process group over a file store in a temporary directory), so the trace
shows what the ghost exchange costs: its copies and its collectives.
Needs one CUDA card; prints the card's name and power limit and writes the
full table to ``chiprun_out/profile_lb_step_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Kernel names of the port's LB libraries, this version's and earlier ones'
PORT_KERNELS = ("field_kernel", "fused_tile_kernel", "gathered_kernel",
                "windowed_kernel", "lb_collision_kernel")


def profile_regime(sim, state, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    sim.run(state, 2)
    torch.cuda.synchronize()
    walls = []                      # unprofiled, for MLUPS
    for _ in range(3):
        t0 = time.perf_counter()
        sim.run(state, steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    nsites = 1
    for s in sim.grid_shape:
        nsites *= s
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
    port = {k for k in by_name if any(p in k for p in PORT_KERNELS)}
    port_us = sum(by_name[k] for k in port)
    return {
        "steps": steps,
        "mlups_unprofiled": nsites * steps / sorted(walls)[1] / 1e6,
        "wall_ms_per_step_unprofiled": sorted(walls)[1] / steps * 1e3,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": busy_us / steps / 1e3,
        "port_kernels_ms_per_step": port_us / steps / 1e3,
        "torch_ops_ms_per_step": (busy_us - port_us) / steps / 1e3,
        "device_busy_share_of_span": busy_us / span_us if span_us else None,
        "device_busy_share_of_wall": busy_us / 1e6 / wall,
        "kernels_traced": len(kernels),
        "torch_kernels_per_step": sum(1 for e in kernels
                                      if e.name not in port) / steps,
        "by_kernel_ms_per_step": {
            k: v / steps / 1e3
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--mesh", default=None, metavar="1[x1[x1]]")
    ap.add_argument("--overlap", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lb_step: no CUDA device is available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    from chip_smoke import nvidia_smi
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")

    smi = nvidia_smi()
    print(smi, flush=True)
    grid = (args.grid,) * 3
    params = LBParams(A=0.125, B=0.125, kappa=0.02)
    out = {"tag": args.tag, "src": str(src), "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0), "grid": grid,
           "mesh": args.mesh, "overlap": args.overlap, "regimes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        kw = {}
        if args.mesh:
            import torch.distributed as dist
            from repro_torch.launch.mesh import make_mesh
            shape = tuple(int(s) for s in args.mesh.split("x"))
            axes = ("px", "py", "pz")[:len(shape)]
            torch.cuda.set_device(0)
            dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1,
                                    device_id=torch.device("cuda", 0))
            kw = dict(mesh=make_mesh(shape, axes), shard_axis=axes,
                      overlap=args.overlap)
        try:
            state = None
            for regime in (False, "one_launch", "two_launch"):
                sim = BinaryFluidSim(grid, params, fused=regime, **kw)
                if state is None:
                    state = sim.init_spinodal(seed=0, noise=0.05)
                row = profile_regime(sim, state, args.steps)
                out["regimes"][str(regime)] = row
                top = dict(list(row["by_kernel_ms_per_step"].items())[:6])
                print(json.dumps({"regime": str(regime), **{
                    k: v for k, v in row.items()
                    if k != "by_kernel_ms_per_step"},
                    "top_kernels_ms_per_step": top}), flush=True)
        finally:
            if args.mesh:
                dist.destroy_process_group()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"profile_lb_step_{args.tag}.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
