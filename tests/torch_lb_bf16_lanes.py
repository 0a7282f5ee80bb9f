"""The rank of the bfloat16 gloo lane of ``test_torch_lb_bf16.py``.

Each rank steps :class:`repro_torch.lb.sim.BinaryFluidSim` in bfloat16
under a 2-rank slab mesh over a file store; rank 0 saves the gathered
state.  This module imports neither ``jax`` nor the reference, so the
spawned ranks start quickly.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim

#: the lane's physics (non-default, so every scalar's rounding shows), grid,
#: regimes, seed and steps
PHYS = dict(A=0.07, B=0.0625, kappa=0.037, tau=0.8, tau_phi=1.2, gamma=0.9)
GRID = (8, 6, 6)
REGIMES = (False, "two_launch")
SEED, STEPS = 4, 4


def run(regime, mesh=None, axes=None):
    """``(f, g)`` of the bfloat16 run of ``regime`` on the CPU, under
    ``mesh`` (gathered on rank 0, ``None`` elsewhere) or on one device."""
    sim = BinaryFluidSim(GRID, LBParams(**PHYS), device="cpu", fused=regime,
                         mesh=mesh, shard_axis=axes, dtype=torch.bfloat16)
    st = sim.gather(sim.step(sim.init_spinodal(seed=SEED), STEPS))
    return None if st is None else (st.f, st.g)


def lane(rank: int, world: int, tmp: str) -> None:
    """One rank (the entry ``torch.multiprocessing`` spawns); rank 0 writes
    ``<tmp>/result.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world,), ("data",), device_type="cpu")
        out = {str(r): run(r, mesh, ("data",)) for r in REGIMES}
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()
