"""Spinodal decomposition as a service — a fleet of binary-fluid
trajectories behind ``tdp.FleetDriver``.

Each "client" submits one quench with its own random seed and its own
mobility (a ``tau_phi`` sweep): the driver batches every request into one
fleet step (one ensemble launch a stage for the whole sweep — per-member
constants ride in a device table, so new values never rebuild anything but
that table), streams progress snapshots back per ticket, and optionally
checkpoints all in-flight trajectories so a killed service resumes every
ticket bit-exactly.

Run:  PYTHONPATH=src python -m repro_torch.examples.lb_fleet [--batch 4
      --steps 40] [--device cpu] [--chaos] [--checkpoint-dir D]
On the card: --batch 64 --grid 32.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tdp
from repro_torch.core import faults
from repro_torch.lb import programs as lbp
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4,
                    help="fleet slots per bucket (also the number of "
                         "submitted trajectories here)")
    ap.add_argument("--backend", default=None,
                    choices=("torch", "cuda"),
                    help="executor; default 'cuda' on the card, 'torch' on "
                         "the CPU")
    ap.add_argument("--vvl", type=int, default=None,
                    help="sites a thread (1, 2, 4 or 8 on 'cuda'; default 1)")
    ap.add_argument("--stream-every", type=int, default=0,
                    help="print phi-variance snapshots of ticket 0 every k "
                         "member steps (0 = off)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint all in-flight tickets here (kill + "
                         "rerun with the same dir resumes them)")
    ap.add_argument("--chaos", action="store_true",
                    help="failure drill: guard all trajectories with a "
                         "HealthPolicy and poison one ticket's g field "
                         "mid-run — the driver quarantines exactly that "
                         "member while the rest complete")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    grid = (args.grid,) * 3
    params = LBParams(A=0.125, B=0.125, kappa=0.02)
    sim = BinaryFluidSim(grid, params, device=args.device)
    backend = args.backend or ("cuda" if sim.device.type == "cuda"
                               else "torch")
    target = tdp.Target(backend, vvl=args.vvl if args.vvl is not None
                        else (1 if backend == "cuda" else None))

    # The served step graph: the unfused LB step with tau_phi (mobility)
    # left as a per-ticket sweep value.  Clients bind their own value in
    # params["consts"]; the driver turns the spread into one BatchedConst
    # bucket.
    prog = lbp.unfused_step_program(
        lbp.collision_consts(np.float32, **params.as_kwargs()))

    # resume-or-fresh: the driver creates checkpoint_dir on construction,
    # so try the restore and fall back when no checkpoint has been written
    drv, resumed = None, {}
    if args.checkpoint_dir:
        try:
            drv = tdp.FleetDriver.restore(args.checkpoint_dir, prog,
                                          device=sim.device, target=target,
                                          batch=args.batch,
                                          checkpoint_every=4)
            resumed = {tid: t.step for tid, t in drv._tickets.items()}
            print(f"[lb_fleet] resumed {len(resumed)} ticket(s) from "
                  f"{args.checkpoint_dir}")
        except FileNotFoundError:
            pass
    health = (tdp.HealthPolicy(fields=("g",), every=2) if args.chaos
              else None)
    if drv is None:
        drv = tdp.FleetDriver(target, batch=args.batch,
                              checkpoint_dir=args.checkpoint_dir,
                              checkpoint_every=4 if args.checkpoint_dir
                              else None,
                              health=health)

    tau_phis = np.linspace(0.8, 1.2, args.batch).astype(np.float32)
    tickets = list(drv._tickets.values())
    if not tickets:
        for i in range(args.batch):
            st = sim.init_spinodal(seed=i, noise=0.05)
            t = drv.submit(prog, {"state": {"f": st.f, "g": st.g},
                                  "consts": {"tau_phi": tau_phis[i]}},
                           args.steps)
            tickets.append(t)
            print(f"[lb_fleet] submitted {t.id}: seed {i}, tau_phi "
                  f"{tau_phis[i]:.2f}, {args.steps} steps")

    def phi_var(state) -> float:
        return float(state["g"].double().sum(0).var())

    victim = None
    if args.chaos and len(tickets) >= 2:
        victim = tickets[1]
        poison_at = max(1, args.steps // 2)
        drv.inject(faults.nan_at_step(victim.id, "g", poison_at))
        print(f"[lb_fleet] chaos: poisoning {victim.id} field 'g' at member "
              f"step {poison_at} (guard: NaN/Inf every 2 steps)")

    t0 = time.perf_counter()
    if args.stream_every:
        for step, snap in drv.stream(tickets[0], every=args.stream_every):
            print(f"[lb_fleet] {tickets[0].id} step {step:>5}: phi_var "
                  f"{phi_var(snap):.5f}")
    final = drv.drain()
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    dt = time.perf_counter() - t0

    nsites = args.grid ** 3
    done_steps = sum(t.step - resumed.get(t.id, 0) for t in tickets)
    print(f"[lb_fleet] {len(tickets)} trajectories x {args.steps} steps on "
          f"{args.grid}^3 on {sim.device} in {dt:.2f}s "
          f"({done_steps * nsites / dt / 1e6:.2f} Msites/s aggregate, "
          f"{len(drv._buckets)} bucket(s))")
    for t in tickets:
        p = drv.poll(t)
        if victim is not None and t.id == victim.id:
            assert p["status"] == "failed", \
                f"{t.id}: expected quarantine, got {p['status']}"
            assert isinstance(p["error"], tdp.HealthError)
        if p["status"] == "failed":
            # the victim, or a ticket that failed before a resumed snapshot
            assert t is victim or t.id in resumed, p["error"]
            print(f"[lb_fleet] {t.id}: quarantined -> {p['error']}")
            continue
        assert p["done"] and p["step"] == t.nsteps, p["status"]
        var = phi_var(final[t.id])
        assert np.isfinite(var), f"{t.id}: non-finite fields"
        print(f"[lb_fleet] {t.id}: tau_phi "
              f"{float(np.asarray(t.consts['tau_phi'])):.2f} -> phi_var "
              f"{var:.5f}")
    print("[lb_fleet] OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
