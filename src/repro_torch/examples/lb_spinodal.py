"""Spinodal decomposition of a binary fluid — the Ludwig-style application.

A symmetric quench (φ = ±noise) phase-separates into domains; this is the
physics the paper's binary-collision benchmark kernel comes from.  Runs the
full targetDP-structured simulation (moments → stencil → collision →
streaming), each regime a compiled ``tdp.Program`` step graph stepped in
chunks by ``CompiledProgram.run`` (two preallocated ping-pong state
buffers), and prints conservation and coarsening observables plus the
per-step memory estimate of the hot loop's ``ProgramPlan``.

Run:  PYTHONPATH=src python -m repro_torch.examples.lb_spinodal [--steps 400]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch import tdp
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim

EPILOG = ("The reference's --mesh and --overlap wait for the port's "
          "decompositions (ROADMAP A4).  Its --donate has no PyTorch "
          "counterpart: tensors are not donated, and CompiledProgram.run "
          "already steps two preallocated ping-pong buffers.")


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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; needs a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the quench; returns the first and last observables, the mass
    drift, the rates of each chunk and the final state."""
    args = parse_args(argv)
    params = LBParams(A=0.125, B=0.125, kappa=0.02)
    target = (None if args.backend is None
              else tdp.Target(args.backend, vvl=args.vvl))
    sim = BinaryFluidSim((args.grid,) * 3, params=params, target=target,
                         vvl=args.vvl if target is None else None,
                         fused=args.fused, device=args.device)
    hot = sim.programs["fused" if args.fused else "step"]
    plan = hot.plan()
    print(f"[lb_spinodal] hot-loop Program {hot.program.name!r}: stages "
          f"{[r['stage'] + '@' + r['executor'] for r in plan.per_stage()]}, "
          f"est. per-step HBM {plan.hbm_bytes_estimate() / 2**20:.1f} MiB")
    state = sim.init_spinodal(seed=0, noise=0.05)

    obs0 = sim.observables(state)
    print(f"{'step':>6} {'mass':>12} {'phi_total':>12} {'phi_var':>10} "
          f"{'phi_range':>16} {'Msites/s':>9}")

    def report(st, rate=0.0):
        o = sim.observables(st)
        print(f"{st.step:>6} {o['mass']:>12.4f} {o['phi_total']:>12.5f} "
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
    print(f"\n[lb_spinodal] mass drift over {args.steps} steps: {drift:.2e}")
    print(f"[lb_spinodal] φ variance {obs0['phi_var']:.5f} → "
          f"{o_end['phi_var']:.5f} (domains formed)")
    return {"first": obs0, "last": o_end, "mass_drift": drift,
            "msites_per_s": rates, "state": state,
            "executors": [r["executor"] for r in plan.per_stage()]}


if __name__ == "__main__":
    main()
