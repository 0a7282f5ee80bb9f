"""The decomposed ``BinaryFluidSim`` across the cards of one host.

    python3 tools/time_decomp.py [--nproc 4] [--local 128] [--steps 20]
                                 [--device cuda|cpu]

Spawns ``--nproc`` ranks, one card each (NCCL; gloo processes with
``--device cpu``), in a process group over a file store in a temporary
directory.  For each mesh of ``--nproc`` ranks (the slab, and the most
even pencil and block that divide it) the global grid is ``--local`` cubed
per rank (weak scaling), and for each regime (unfused, ``one_launch``,
``two_launch``):

* the decomposed run, 20 steps from the spinodal quench (seed 0), gathered
  on rank 0 and held to the one-device run of the global grid on rank 0's
  card (max |difference|, bit-equality);
* the collectives counted over a step of the hot loop, against
  ``comm_stats()``;
* on the cards: the exchange round's device ms (CUDA events around
  ``CompiledProgram.exchange``) and the hot step's, the slowest rank's,
  and MLUPS of the global grid (host clock, median of three) beside rank
  0's one-card MLUPS at the local size (with ``--device cpu`` the ranks
  rehearse the answers and the counts, and time nothing).

Prints the card's name and power limit, one JSON line per run, and writes
``chiprun_out/time_decomp.json``.  Exits non-zero if a run differs from
the one-device run past ``rtol=1e-5, atol=1e-6`` or miscounts its
collectives.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
REGIMES = (False, "one_launch", "two_launch")


def meshes(n: int) -> dict:
    """Slab, and the most even pencil and block of ``n`` ranks."""
    out = {"slab": (n,)}
    a = max(d for d in range(1, math.isqrt(n) + 1) if n % d == 0)
    if a > 1:
        out["pencil"] = (n // a, a)
    b = max(d for d in range(1, round(n ** (1 / 3)) + 2) if n % d == 0
            and d ** 3 <= n)
    if b > 1 and (n // b) > 1:
        c = max(d for d in range(1, math.isqrt(n // b) + 1)
                if (n // b) % d == 0)
        if c > 1:
            out["block"] = (n // (b * c), c, b)
    return out


def _timed(fn, device) -> float | None:
    """Device ms of one call of ``fn`` (``chip_smoke.time_ms``: CUDA events
    over 10 calls behind a spin kernel); ``None`` on the CPU, where the
    ranks only rehearse the answers and the counts."""
    if device.type != "cuda":
        return None
    from chip_smoke import time_ms
    return time_ms(fn, reps=10, hold=500_000_000)


def _mlups(sim, state, steps, nsites, sync) -> float:
    sim.run(state, 2)
    rates = []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        sim.run(state, steps)
        sync()
        rates.append(nsites * steps / (time.perf_counter() - t) / 1e6)
    return statistics.median(rates)


def rank_main(rank: int, world: int, tmp: str, args) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim

    prog = importlib.import_module("repro_torch.core.program")
    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world,
                                device_id=device)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)

    def sync():
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    def slowest(x: float | None) -> float | None:
        if x is None:
            return None
        t = torch.tensor([x], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    params = LBParams(**PARAMS)
    local = (args.local,) * 3
    rows, failed = [], False
    try:
        one = dict.fromkeys(REGIMES)
        if rank == 0 and on_card:
            for regime in REGIMES:
                sim = BinaryFluidSim(local, params, fused=regime,
                                     device=device)
                one[regime] = _mlups(sim, sim.init_spinodal(seed=0),
                                     args.steps, math.prod(local),
                                     torch.cuda.synchronize)
        for kind, shape in meshes(world).items():
            axes = ("px", "py", "pz")[:len(shape)]
            mesh = make_mesh(shape, axes, device_type=device.type)
            grid = tuple(n * s for n, s in zip(
                local, shape + (1,) * (3 - len(shape))))
            for regime in REGIMES:
                sim = BinaryFluidSim(grid, params, fused=regime,
                                     device=device, mesh=mesh,
                                     shard_axis=axes)
                st0 = sim.init_spinodal(seed=0)
                full = sim.gather(sim.run(st0, args.steps))
                hot = sim.programs["fused" if regime else "step"]
                state = {"f": st0.f, "g": st0.g}
                sync()
                prog.collectives["all_to_all_single"] = 0
                hot.run(state, args.steps)
                per_step = prog.collectives["all_to_all_single"] / args.steps
                sync()
                row = {
                    "mesh": kind, "shape": list(shape), "grid": list(grid),
                    "regime": str(regime),
                    "collectives_per_step": per_step,
                    "ppermutes_per_step": hot.comm_stats()[
                        "ppermutes_per_step"],
                    "exchanged_bytes_per_step": hot.comm_stats()[
                        "exchanged_bytes_per_step"],
                    "exchange_ms": slowest(_timed(
                        lambda: hot.exchange(state), device)),
                    "step_ms": slowest(_timed(lambda: hot.step(state),
                                              device)),
                    "mlups": _mlups(sim, st0, args.steps, math.prod(grid),
                                    sync) if on_card else None,
                }
                if rank == 0:
                    ref_sim = BinaryFluidSim(grid, params, fused=regime,
                                             device=device)
                    ref = ref_sim.run(ref_sim.init_spinodal(seed=0),
                                      args.steps)
                    diff = {k: float((getattr(full, k) - getattr(ref, k))
                                     .abs().max()) for k in ("f", "g")}
                    same = all(torch.equal(getattr(full, k), getattr(ref, k))
                               for k in ("f", "g"))
                    close = all(torch.allclose(getattr(full, k),
                                               getattr(ref, k), rtol=1e-5,
                                               atol=1e-6) for k in ("f", "g"))
                    row.update(max_abs_vs_one_device=diff, bit_equal=same,
                               one_card_local_mlups=one[regime])
                    failed |= not close or per_step != row[
                        "ppermutes_per_step"]
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                    del ref_sim, ref
                del sim, full
        if rank == 0:
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            (ROOT / "chiprun_out" / "time_decomp.json").write_text(
                json.dumps({"ranks": world, "local": local, "rows": rows},
                           indent=1))
            if failed:
                raise RuntimeError("a decomposed run differs from the "
                                   "one-device run or miscounts its "
                                   "collectives")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--local", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            print(f"time_decomp: {args.nproc} ranks need {args.nproc} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip(),
              flush=True)
        _build.build()                 # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(args.nproc, tmp, args),
                           nprocs=args.nproc, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
