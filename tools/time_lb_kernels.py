"""Check and time the LB kernels (``"cuda"`` and ``"cuda_windowed"``) on one card.

    python3 tools/time_lb_kernels.py [--src DIR] [--tag NAME] [--grid 128]

Builds the CUDA sources of the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``) and, on seeded random float32 inputs at
``--grid``³, for every D3Q19 site function of both executors:

* holds the kernel to its plain version (``stream`` bit-exact, the rest at
  ``rtol=1e-5, atol=1e-6``, as ``chip_smoke.py`` does) at VVL 1, 2, 4 and
  8 and, where the executor declares the ``plane_block`` tunable, for the
  windowed ``fused`` at each ``PLANE_BLOCKS`` value;
* times the kernel alone on its prepared operands (``ms``, median of 20
  launches between CUDA events, as ``chip_smoke.py`` times) and a whole
  ``launch`` through the package's API, its prologue (gather, pad or none)
  included (``launch_ms``), at VVL 1 and the default ``plane_block``; the
  windowed ``fused`` also at each ``plane_block`` (``ms_by_plane_block``);

beside the bound (bytes: each input read once, each output written once, at
3.35 TB/s).  Each row also carries a digest of the kernel's output bits at
every VVL and ``plane_block`` (``digests``), and ``lb_collision.cu``'s
kernel is checked, digested and timed the same way on 128³ + 37 sites, so
two checkouts' float32 kernels can be held to the same bits.  The operands are prepared by the package's own prologue for
each executor's declared contract, so ``--src`` may point at another
checkout's ``src`` (one unpacked with ``git archive``) whose executors take
gathered stacks or halo-extended grids: run the script once per version, in
turns, within one call.  Prints the card's name and power limit, then one
JSON object (with ``ptxas``'s registers and spills of each LB kernel), and
writes it to ``chiprun_out/time_lb_kernels_<tag>.json``; exits non-zero
when a kernel disagrees with its plain version or no card is present.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (PHYS, bound, compare, max_abs,  # noqa: E402
                        nvidia_smi, ptxas_report, time_ms)

VVLS = (1, 2, 4, 8)
PLANE_BLOCKS = (1, 2, 4, 8, 16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--grid", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lb_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.core import Lattice, Target, api, launch
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.core.registry import get_executor_entry
    from repro_torch.kernels import _build, tdp_pointwise, tdp_windowed
    from repro_torch.lb import programs, stencil
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report({k: _build.build_dir() / f"{k}.log"
                          for k in ("tdp_gathered", "tdp_windowed")})
    dev = torch.device("cuda")
    grid = (args.grid,) * 3
    lat = Lattice(grid)
    nsites = int(np.prod(grid))
    problems: list[str] = []

    def prologue(exe):
        """The package's own prologue for ``exe``'s declared contract."""
        entry = get_executor_entry(exe)
        if getattr(entry, "takes_fields", False):
            return api.field_view
        if entry.wants == "halo_extended":
            return api.halo_extend
        return api.gather_neighbors

    def plain(exe, plan, prepared):
        if hasattr(tdp_pointwise, "fields_plain"):
            return tdp_pointwise.fields_plain(plan, prepared)
        if exe == "cuda_windowed":
            return tdp_windowed.windowed_plain(plan, prepared)
        return torch_executor(plan, prepared)

    def inputs(spec, seed):
        r = np.random.default_rng(seed)
        xs = []
        for fs in spec.fields:
            x = r.standard_normal((fs.ncomp, nsites), dtype=np.float32)
            x = 1.0 / 19.0 + 0.01 * x if fs.name == "f" else 0.05 * x
            xs.append(torch.from_numpy(x).to(dev))
        return xs

    def digest(outs) -> str:
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().view(torch.int32).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    tiled = "plane_block" in get_executor_entry("cuda_windowed").tunables
    rows = []
    for exe, run in (("cuda", tdp_pointwise.cuda_execute),
                     ("cuda_windowed", tdp_windowed.windowed_execute)):
        prep = prologue(exe)
        for site in _build.SITES:
            spec = stencil.SPECS[site]
            if exe == "cuda_windowed" and not spec.has_stencil:
                continue
            consts = programs.collision_consts(**PHYS) if spec.consts else {}
            xs = inputs(spec, _build.SITE_ID[site])
            halo = (0, 0, 0)
            prepared = tuple(x if s is None else prep(x, grid, halo, s)
                             for x, s in zip(xs, spec.stencils))
            pbs = (None,) + (PLANE_BLOCKS if tiled and exe == "cuda_windowed"
                             and site == "fused" else ())

            def target(vvl, pb):
                t = Target(exe, vvl=vvl)
                return t if pb is None else t.with_tuning(plane_block=pb)

            want = plain(exe, launch_plan(spec, target(1, None), lattice=lat,
                                          consts=consts), prepared)
            err = 0.0
            digests = {}
            for vvl in VVLS:
                for pb in pbs:
                    plan = launch_plan(spec, target(vvl, pb), lattice=lat,
                                       consts=consts)
                    got = run(plan, prepared)
                    torch.cuda.synchronize()
                    compare(site, got, want, f"{exe}.{site} vvl={vvl} "
                            f"plane_block={pb}", problems)
                    err = max(err, max_abs(got, want))
                    digests[f"{vvl}/{pb}"] = digest(got)
                    del got
            del want
            ms_by_pb = {}
            for pb in pbs:
                plan = launch_plan(spec, target(1, pb), lattice=lat,
                                   consts=consts)
                ms_by_pb[str(pb)] = time_ms(
                    lambda plan=plan: run(plan, prepared))
            tgt = target(1, None)
            launch_ms = time_ms(lambda: launch(spec, tgt, *xs, lattice=lat,
                                               consts=consts))
            b_ms, b_by = bound(site, nsites)
            row = {"name": f"{exe}.{site}", "ms": ms_by_pb.pop("None"),
                   "ms_by_plane_block": ms_by_pb or None,
                   "launch_ms": launch_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "max_abs_err": err, "digests": digests}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
            del xs, prepared
            torch.cuda.empty_cache()
    # kernel 3 on a ragged site count
    from repro_torch.kernels import lb_collision
    n = nsites + 37
    r = np.random.default_rng(_build.SITE_ID["collide"])
    xs = []
    for fs in stencil.SPECS["collide"].fields:
        x = r.standard_normal((fs.ncomp, n), dtype=np.float32)
        x = 1.0 / 19.0 + 0.01 * x if fs.name == "f" else 0.05 * x
        xs.append(torch.from_numpy(x).to(dev))
    want = lb_collision.collision_site_kernel(
        *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
    digests, err = {}, 0.0
    for vvl in VVLS:
        got = lb_collision.lb_collision(*xs, vvl=vvl, **PHYS)
        torch.cuda.synchronize()
        compare("collide", got, want, f"lb_collision vvl={vvl}", problems)
        err = max(err, max_abs(got, want))
        digests[f"{vvl}/None"] = digest(got)
    b_ms, b_by = bound("collide", n)
    rows.append({"name": "lb_collision.collide", "n": n,
                 "ms": time_ms(lambda: lb_collision.lb_collision(*xs, **PHYS)),
                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                 "digests": digests})
    print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    del xs, want
    result = {"tag": args.tag, "src": str(src), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0), "grid": grid,
              "build_s": build_s, "ptxas": ptxas, "rows": rows,
              "problems": problems}
    print(json.dumps(result), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"time_lb_kernels_{args.tag}.json").write_text(
        json.dumps(result, indent=1))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
