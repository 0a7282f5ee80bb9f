"""Spinodal decomposition of a binary fluid — the Ludwig-style application.

A symmetric quench (φ = ±noise) phase-separates into domains; this is the
physics the paper's binary-collision benchmark kernel comes from.  Runs the
full targetDP-structured simulation (moments → stencil → collision →
streaming), each regime a compiled ``tdp.Program`` step graph stepped in
chunks by ``CompiledProgram.run`` (two preallocated ping-pong state
buffers), and prints conservation and coarsening observables plus the
per-step memory estimate of the hot loop's ``ProgramPlan``.

With ``--mesh`` the grid is decomposed over the ranks of a process group
(slab, pencil or block) and the ghost planes travel over
``torch.distributed``: NCCL on the card, gloo on the CPU.  The ranks come
from the environment as ``torchrun`` sets it (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); without it the run is one rank, on a
process group of its own.  Rank 0 prints.

Run:  PYTHONPATH=src python -m repro_torch.examples.lb_spinodal [--steps 400]
      [--device cpu]
      PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
          -m repro_torch.examples.lb_spinodal --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch.distributed as dist

from repro_torch import tdp
from repro_torch.launch.mesh import make_mesh
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim

EPILOG = ("The reference's --donate has no PyTorch counterpart: tensors are "
          "not donated, and CompiledProgram.run already steps two "
          "preallocated ping-pong buffers.")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 epilog=EPILOG)
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--backend", default=None,
                    choices=("torch", "cuda", "cuda_windowed"),
                    help="executor; default: 'cuda' (unfused) or "
                         "'cuda_windowed' (fused) on the card, 'torch' on "
                         "the CPU.  cuda_windowed is stencil-only: pair it "
                         "with --fused")
    ap.add_argument("--vvl", type=int, default=None,
                    help="sites a thread (1, 2, 4 or 8 on the CUDA "
                         "executors; default 1)")
    ap.add_argument("--fused", nargs="?", const="one_launch", default=False,
                    choices=("one_launch", "two_launch"),
                    help="fused stream+gradient+collide stencil launch(es) "
                         "per step (same trajectory): one_launch = radius-2 "
                         "composed stencil; two_launch = streamed-phi "
                         "intermediate")
    ap.add_argument("--mesh", default=None, metavar="NxM[xK]",
                    help="decompose the grid over the ranks: '4' = slab, "
                         "'2x2' = pencil, '2x2x2' = block (mesh axis k "
                         "shards grid dim k); the product is the number of "
                         "ranks (torchrun's --nproc-per-node)")
    ap.add_argument("--overlap", action="store_true",
                    help="launch each stage's interior while the ghost "
                         "exchanges are in flight (with --mesh)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; needs a card) or cpu")
    return ap.parse_args(argv)


@contextlib.contextmanager
def _ranks(device: str):
    """The process group of a decomposed run: the caller's if one is
    initialised, else one from torchrun's environment, else a group of one
    rank over a file store in a temporary directory.  A group made here is
    destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend,
                                    init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    """Run the quench; returns the first and last observables, the mass
    drift, the rates of each chunk, the final state (this rank's block
    under ``--mesh``) and, under ``--mesh``, the hot loop's comm stats."""
    args = parse_args(argv)
    if args.mesh is None:
        return _run(args, None, None)
    shape = tuple(int(s) for s in args.mesh.lower().split("x"))
    axes = tuple(f"p{'xyz'[d]}" for d in range(len(shape)))
    with _ranks(args.device):
        return _run(args, make_mesh(shape, axes, device_type=args.device),
                    axes)


def _run(args, mesh, shard_axis) -> dict:
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    params = LBParams(A=0.125, B=0.125, kappa=0.02)
    target = (None if args.backend is None
              else tdp.Target(args.backend, vvl=args.vvl))
    sim = BinaryFluidSim((args.grid,) * 3, params=params, target=target,
                         vvl=args.vvl if target is None else None,
                         fused=args.fused, device=args.device, mesh=mesh,
                         shard_axis=shard_axis, overlap=args.overlap)
    hot = sim.programs["fused" if args.fused else "step"]
    plan = hot.plan()
    if mesh is not None:
        kind = "slab pencil block".split()[len(shard_axis) - 1]
        say(f"[lb_spinodal] mesh "
            f"{dict(zip(shard_axis, mesh.shape))}: {kind} decomposition, "
            f"local block {hot.local_shape}")
    say(f"[lb_spinodal] hot-loop Program {hot.program.name!r}: stages "
        f"{[r['stage'] + '@' + r['executor'] for r in plan.per_stage()]}, "
        f"est. per-step HBM {plan.hbm_bytes_estimate() / 2**20:.1f} MiB")
    cs = None
    if mesh is not None:
        cs = hot.comm_stats()
        say(f"[lb_spinodal] exchange schedule {hot.exchange_schedule}: "
            f"{cs['exchanged_bytes_per_step'] / 2**10:.1f} KiB and "
            f"{cs['ppermutes_per_step']} collectives per step"
            + (f"; overlap interior fraction "
               f"{cs['interior_fraction']:.2f}" if cs["overlap"] else ""))
    state = sim.init_spinodal(seed=0, noise=0.05)

    obs0 = sim.observables(state)
    say(f"{'step':>6} {'mass':>12} {'phi_total':>12} {'phi_var':>10} "
        f"{'phi_range':>16} {'Msites/s':>9}")

    def report(st, rate=0.0):
        o = sim.observables(st)
        say(f"{st.step:>6} {o['mass']:>12.4f} {o['phi_total']:>12.5f} "
            f"{o['phi_var']:>10.5f} "
            f"[{o['phi_min']:>6.3f},{o['phi_max']:>6.3f}] "
            f"{rate:>9.2f}")
        assert not o["nan"], "NaN in fields"
        return o

    report(state)
    n = sim.grid_shape[0] ** 3
    rates = []
    while state.step < args.steps:
        chunk = min(args.chunk, args.steps - state.step)
        t0 = time.perf_counter()
        state = sim.run(state, chunk)
        tdp.sync_target(state.f)
        rates.append(n * chunk / (time.perf_counter() - t0) / 1e6)
        report(state, rate=rates[-1])

    o_end = sim.observables(state)
    drift = abs(o_end["mass"] - obs0["mass"]) / obs0["mass"]
    say(f"\n[lb_spinodal] mass drift over {args.steps} steps: {drift:.2e}")
    say(f"[lb_spinodal] φ variance {obs0['phi_var']:.5f} → "
        f"{o_end['phi_var']:.5f} (domains formed)")
    return {"first": obs0, "last": o_end, "mass_drift": drift,
            "msites_per_s": rates, "state": state, "comm_stats": cs,
            "executors": [r["executor"] for r in plan.per_stage()]}


if __name__ == "__main__":
    main()
