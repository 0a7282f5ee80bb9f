"""Check and time kernel 2's example entry and ``reduce`` on one card.

    python3 tools/time_example_kernels.py [--src DIR] [--tag NAME]

Builds ``csrc/tdp_gathered_example.cu`` of the ``repro_torch`` package under
``--src`` (default: this checkout's ``src``) and, on seeded random float32
fields of (3, 128³) — the paper's §III-C example at Ludwig's size a device:

* holds ``scale``, ``saxpy`` and ``site_pos`` to their plain bodies, bit for
  bit, at VVL 1, 2, 4 and 8 and under ``layout="aosoa"`` at W 8, 16 and 32 (on
  operands already in AoSoA), and times each (median of 20 launches
  between CUDA events, as ``chip_smoke.py`` times);
* times ``reduce`` of ``scale`` (a = 1) under ``Target("cuda")`` — sum at
  VVL 1, 2, 4 and 8, max and min at VVL 1 — through
  ``repro_torch.core.execute.reduce``, whatever route the version takes,
  max and min exact against the plain route, the sum within ``rtol=1e-6,
  atol=1e-6`` of the sum it computes (the float64 sum for the one-pass
  kernel, the plain route's float32 ``torch.sum`` for a map plus
  ``torch.sum``) and within 1e-5·Σ|x| of the float64 sum;
* beside ``torch.mul``, ``torch.add(y, x, alpha=a)``, ``x.sum(-1)`` (and
  with ``dtype=torch.float64``), ``x.amax(-1)`` and ``x.amin(-1)`` on the
  same inputs, and the bound
  (bytes: each input read once, each output written once, at 3.35 TB/s).

``--src`` may point at another checkout's ``src`` (one unpacked with ``git
archive``): run the script once per version, in turns, within one call.
Prints the card's name and power limit, then one JSON object (with
``ptxas``'s registers and spills of each example kernel), and writes it to
``chiprun_out/time_example_kernels_<tag>.json``; exits non-zero when a
kernel disagrees with its plain version or no card is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (GRID, PEAK_BYTES_PER_S, SHORT_HOLD,  # noqa: E402
                        TDP_A, TDP_NCOMP, nvidia_smi, ptxas_report, time_ms)

VVLS = (1, 2, 4, 8)
WIDTHS = (8, 16, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_example_kernels: no CUDA device is available",
              file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.core.execute import reduce
    from repro_torch.kernels import _build
    from repro_torch.kernels import example_sites as ex
    from repro_torch.kernels import tdp_pointwise as tp
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")

    smi = nvidia_smi()
    print(smi, flush=True)
    # only the example library: the others take a minute to build
    _build.SOURCES = ("tdp_gathered_example",)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report({"tdp_gathered_example": _build.build_dir()
                          / "tdp_gathered_example.log"})
    dev = torch.device("cuda")
    n = int(np.prod(GRID))
    g = torch.Generator(device=dev).manual_seed(33)
    x, y = (torch.randn(TDP_NCOMP, n, device=dev, generator=g)
            for _ in range(2))
    problems: list[str] = []
    rows = []

    def quick(fn):
        return time_ms(fn, hold=SHORT_HOLD)

    libs = {"scale": lambda: torch.mul(x, TDP_A),
            "saxpy": lambda: torch.add(y, x, alpha=TDP_A), "site_pos": None}
    for site in ex.SPECS:
        spec = dataclasses.replace(ex.SPECS[site], out=TDP_NCOMP)
        xs = [x, y] if site == "saxpy" else [x]
        consts = {} if site == "site_pos" else {"a": TDP_A}
        want = torch_executor(launch_plan(spec, Target("torch"),
                                          consts=consts), xs)[0]
        ms_by_vvl, ms_by_width = {}, {}
        for v in VVLS:
            plan = launch_plan(spec, Target("cuda", vvl=v), consts=consts)
            got = tp.cuda_execute(plan, xs)[0]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                problems.append(f"{site} vvl={v}: not the plain bits")
            ms_by_vvl[v] = quick(lambda p=plan: tp.cuda_execute(p, xs))
        for w in WIDTHS:
            plan = launch_plan(spec, Target("cuda", vvl=w, layout="aosoa"),
                               consts=consts)
            blocks = tp.aosoa_operands(plan, xs)
            got = tp._aosoa_launch(plan, site, blocks, n, None)[0]
            torch.cuda.synchronize()
            if not torch.equal(tp.aosoa_to_soa(got, n), want):
                problems.append(f"{site} aosoa W={w}: not the plain bits")
            ms_by_width[w] = quick(lambda p=plan, b=blocks: tp._aosoa_launch(
                p, site, b, n, None))
        lib = libs[site]
        nbytes = (8 + 4 * (len(xs) - 1)) * TDP_NCOMP * n
        rows.append({"name": f"tdp_gathered.{site}", "ms_by_vvl": ms_by_vvl,
                     "aosoa_ms_by_width": ms_by_width,
                     "library_ms": None if lib is None else quick(lib),
                     "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        del want

    spec = dataclasses.replace(ex.SCALE_SPEC, out=TDP_NCOMP)

    def red(op, backend="cuda", vvl=None):
        return reduce(spec, None, [x], consts={"a": 1.0}, op=op,
                      target=Target(backend, vvl=vvl))

    x64 = x.double()
    ms_by_op, lib_by_op = {}, {}
    lib_by_op["sum_float64_acc"] = quick(
        lambda: x.sum(-1, dtype=torch.float64))
    for op, lib in (("sum", lambda: x.sum(-1)), ("max", lambda: x.amax(-1)),
                    ("min", lambda: x.amin(-1))):
        got, want = red(op), red(op, "torch")
        torch.cuda.synchronize()
        if op == "sum":
            # the one-pass kernel sums in double, a map plus torch.sum in
            # float32: each is held at 1e-6 to the sum it computes
            err = (got.double() - x64.sum(-1)).abs()
            ok = ((torch.allclose(got.double(), x64.sum(-1), rtol=1e-6,
                                  atol=1e-6)
                   or torch.allclose(got, want, rtol=1e-6, atol=1e-6))
                  and bool((err <= 1e-5 * x64.abs().sum(-1)).all()))
        else:
            ok = torch.equal(got, want)
        if not ok:
            problems.append(f"reduce {op}: {got.tolist()} vs plain "
                            f"{want.tolist()}")
        ms_by_op[op] = quick(lambda op=op: red(op))
        lib_by_op[op] = quick(lib)
    rows.append({"name": "reduce(scale)", "ms_by_op": ms_by_op,
                 "sum_ms_by_vvl": {v: quick(lambda v=v: red("sum", vvl=v))
                                   for v in VVLS},
                 "library_ms_by_op": lib_by_op,
                 "bound_ms": 4 * TDP_NCOMP * n / PEAK_BYTES_PER_S * 1e3,
                 "sum_minus_float64": (red("sum").double()
                                       - x64.sum(-1)).tolist(),
                 "torch_sum_minus_float64": (x.sum(-1).double()
                                             - x64.sum(-1)).tolist(),
                 "sum": x64.sum(-1).tolist()})
    print(json.dumps(rows[-1]), file=sys.stderr, flush=True)

    result = {"tag": args.tag, "src": str(src), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0),
              "shape": [TDP_NCOMP, n], "build_s": build_s, "ptxas": ptxas,
              "rows": rows, "problems": problems}
    print(json.dumps(result), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"time_example_kernels_{args.tag}.json").write_text(
        json.dumps(result, indent=1))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
