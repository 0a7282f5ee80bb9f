"""Quickstart: the paper's §III-C scale example, end to end.

Mirrors the paper's host-side call sequence:

    targetMalloc → copyToTarget → copyConstantDoubleToTarget
    → scale TARGET_LAUNCH(N) (t_field) → syncTarget
    → copyFromTarget → targetFree

through the declarative API: the kernel's field roles are declared once
(``SCALE_SPEC``, :mod:`repro_torch.kernels.example_sites`) and the paper's
C-vs-CUDA build switch is the exchangeable ``tdp.Target``: ``"cuda"`` (the
hand-written kernel, VVL swept over 1, 2, 4, 8) on the card, ``"torch"``
(the plain body) with ``--device cpu``.  Then a §V reduction, and a new
executor registered in one call.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import tdp
from repro_torch.kernels.example_sites import SCALE_SPEC


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the CUDA kernel (the default; needs a card); "
                         "cpu: the plain body under Target('torch')")
    ap.add_argument("--grid", type=int, default=32,
                    help="lattice extent per dimension")
    args = ap.parse_args(argv)
    backend = "cuda" if args.device == "cuda" else "torch"

    # host field, SoA (paper §III-B), its target copy and a target buffer
    # for the result
    lattice = tdp.Lattice((args.grid,) * 3)
    t_out = tdp.target_malloc((3, lattice.nsites), device=args.device)
    host = tdp.Field(lattice, ncomp=3, dtype=np.float64)
    host.data[...] = np.random.default_rng(0).normal(size=host.array_shape)
    t_field = tdp.copy_to_target(host, device=args.device, dtype=np.float32)
    a = tdp.copy_constant_to_target(2.0)                  # TARGET_CONST
    want = 2.0 * tdp.copy_from_target(t_field)

    # launch under every VVL the kernels are built for
    for vvl in tdp.CUDA_VVLS:
        tdp.launch(SCALE_SPEC, tdp.Target(backend, vvl=vvl), t_field,
                   lattice=lattice, a=a, out=t_out)
        tdp.sync_target(t_out)
        got = tdp.copy_from_target(t_out)
        assert np.array_equal(got, want), (backend, vvl)
    print(f"[quickstart] target={backend} OK (VVL swept "
          f"{'/'.join(map(str, tdp.CUDA_VVLS))}, {lattice.nsites} sites)")

    # reductions — the paper's §V planned extension
    total = tdp.reduce(SCALE_SPEC, lattice, [t_field], consts={"a": 1.0},
                       op="sum", target=backend)
    print(f"[quickstart] reduce(sum) per component: "
          f"{total.cpu().numpy()}")

    # the registry is open: one register_executor call adds an executor
    def whole_lattice_executor(plan, prepared, out=None):
        vals = plan.kernel(*prepared, **plan.consts)
        return vals if isinstance(vals, tuple) else (vals,)

    tdp.register_executor("toy", whole_lattice_executor)
    try:
        out = tdp.launch(SCALE_SPEC, tdp.Target("toy"), t_field, a=a)
        assert np.array_equal(tdp.copy_from_target(out), want)
        executors = tdp.list_executors()
    finally:
        tdp.unregister_executor("toy")
    print(f"[quickstart] registered executors: {executors}")

    tdp.target_free(t_field)
    tdp.target_free(t_out)
    print("[quickstart] single source ran on every executor — done")
    return {"backend": backend, "sum": total.cpu().numpy(),
            "executors": executors}


if __name__ == "__main__":
    main()
