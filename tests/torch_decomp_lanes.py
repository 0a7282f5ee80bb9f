"""The ranks of the gloo lanes of ``test_torch_decomp.py``.

A lane is one process group of CPU processes over a file store: each rank
steps :class:`repro_torch.lb.sim.BinaryFluidSim` under one mesh, and rank 0
saves what the test holds to the reference (the gathered states, the
schedules, the counted collectives, the observables).  This module imports
neither ``jax`` nor the reference, so the spawned ranks start quickly.
"""
from __future__ import annotations

import importlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim

PARAMS = LBParams(A=0.125, B=0.125, kappa=0.02)
_prog = importlib.import_module("repro_torch.core.program")

#: (grid, fused, seed, steps, overlap) of each case, by name
CASES = {
    "unfused_16x8x8": ((16, 8, 8), False, 1, 5, None),
    "one_launch_16x8x8": ((16, 8, 8), "one_launch", 1, 5, None),
    "two_launch_16x8x8": ((16, 8, 8), "two_launch", 1, 5, None),
    # the 1-plane slab on 4 ranks (2 planes on 2): g's width-2 exchange
    # hops two ranks on 4
    "unfused_4x8x8": ((4, 8, 8), False, 2, 4, None),
    "two_launch_16cubed": ((16, 16, 16), "two_launch", 3, 10, None),
    "two_launch_16cubed_overlap": ((16, 16, 16), "two_launch", 3, 10, True),
    "two_launch_16cubed_5": ((16, 16, 16), "two_launch", 3, 5, None),
    # the thin pencil: local (4, 1, 8), g's width-2 exchange in dim 1 hops
    # two ranks each way
    "two_launch_8x4x8": ((8, 4, 8), "two_launch", 1, 5, None),
}

#: mesh shape, axis names and cases of each lane
LANES = {
    "slab2": ((2,), ("data",), ("unfused_16x8x8", "two_launch_16x8x8",
                                "unfused_4x8x8")),
    "slab4": ((4,), ("data",), ("unfused_16x8x8", "one_launch_16x8x8",
                                "two_launch_16x8x8", "unfused_4x8x8")),
    "pencil": ((2, 2), ("px", "py"), ("two_launch_16cubed",
                                      "two_launch_16cubed_overlap")),
    "block": ((2, 2, 2), ("bx", "by", "bz"), ("two_launch_16cubed_5",)),
    "thin": ((2, 4), ("tx", "ty"), ("two_launch_8x4x8",)),
}

#: (nranks, local planes, width) of the exchanges held to a global roll over
#: the slab lane's real collectives
EXCHANGES = [(4, 2, 1), (4, 2, 3), (4, 1, 2), (4, 1, 4)]


def lane(rank: int, world: int, tmp: str, name: str) -> None:
    """One rank of lane ``name`` (the entry ``torch.multiprocessing``
    spawns); rank 0 writes ``<tmp>/result.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        shape, axes, cases = LANES[name]
        mesh = make_mesh(shape, axes, device_type="cpu")
        out = {case: _case(mesh, axes, *CASES[case]) for case in cases}
        if name == "slab4":
            out["exchange_dim"] = _exchange_dim_checks(mesh)
        if name == "pencil":
            out["example"] = _example()
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()


def _expected_collectives(sim, steps: int) -> int:
    """Collectives of ``sim.step(state, steps)`` by the programs'
    ``comm_stats``."""
    pp = {k: exe.comm_stats()["ppermutes_per_step"]
          for k, exe in sim.programs.items()}
    if sim.fused:
        return pp["collide"] + (steps - 1) * pp["fused"] + pp["stream"]
    return steps * pp["step"]


def _case(mesh, axes, grid, fused, seed, steps, overlap) -> dict:
    sim = BinaryFluidSim(grid, PARAMS, device="cpu", fused=fused, mesh=mesh,
                         shard_axis=axes, overlap=overlap)
    st0 = sim.init_spinodal(seed=seed)
    _prog.collectives["all_to_all_single"] = 0
    st = sim.step(st0, steps)
    counted = _prog.collectives["all_to_all_single"]
    ran = sim.run(st0, steps)
    same = torch.equal(st.f, ran.f) and torch.equal(st.g, ran.g)
    flags = torch.tensor([float(same)])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    full = sim.gather(st)
    return {
        "f": None if full is None else full.f,
        "g": None if full is None else full.g,
        "run_equals_step": bool(flags.item()),
        "collectives": counted,
        "expected_collectives": _expected_collectives(sim, steps),
        "local_shape": sim.local_shape,
        "programs": {k: {"halo_schedule": exe.halo_schedule,
                         "exchange_schedule": exe.exchange_schedule,
                         "overlap": exe.overlap,
                         "comm_stats": exe.comm_stats()}
                     for k, exe in sim.programs.items()},
        "observables": sim.observables(st),
    }


def _exchange_dim_checks(mesh) -> dict:
    """``_exchange_dim`` over the mesh's real collectives against the wrap-
    indexed global array, for single- and multi-hop widths: every rank
    checks its own shard; the lane records whether all agreed."""
    rank = dist.get_rank()
    out = {}
    for nranks, loc, width in EXCHANGES:
        rng = np.random.default_rng(nranks * 100 + loc * 10 + width)
        glob = rng.standard_normal((2, 3, nranks * loc)).astype(np.float32)
        shard = torch.from_numpy(
            np.ascontiguousarray(glob[:, :, rank * loc:(rank + 1) * loc]))
        got = _prog._exchange_dim(shard, "data", width, 1, mesh=mesh)
        want = glob[:, :, np.arange(rank * loc - width,
                                    (rank + 1) * loc + width) % glob.shape[2]]
        ok = torch.tensor([float(np.array_equal(got.numpy(), want))])
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        out[(nranks, loc, width)] = bool(ok.item())
    return out


def _example() -> dict:
    """The spinodal example under ``--mesh 2x2`` on this lane's group."""
    from repro_torch.examples import lb_spinodal
    r = lb_spinodal.main(["--device", "cpu", "--grid", "8", "--steps", "4",
                          "--chunk", "2", "--mesh", "2x2"])
    return {k: r[k] for k in ("first", "last", "mass_drift", "comm_stats")}
