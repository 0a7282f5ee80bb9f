"""Time the gathered LM kernels (rmsnorm, gated, act) on one card.

    python3 tools/time_lm_kernels.py [--src DIR] [--tag NAME]

Builds the CUDA sources of the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``) and, on seeded random float32 inputs,
holds each kernel to its plain version at ``rtol=2e-4, atol=2e-4`` at VVL
1, 2, 4 and 8, then times it at each VVL (median of 20 launches between
CUDA events, as ``chip_smoke.py`` times) beside one PyTorch call computing
the same function and the bound (bytes: each input read once, each output
written once, at 3.35 TB/s):

* ``rmsnorm`` at gemma2-2b's and falcon-mamba-7b's prefill (2304, 9216),
  (4096, 8192) and decode (2304, 2), (4096, 2) shapes, against
  ``F.rms_norm``;
* ``gated`` (geglu) and ``act`` (gelu, against ``F.gelu``) over gemma2-2b's
  2 × 4608 × 9216 MLP activations.

``--src`` may point at another checkout's ``src`` (one unpacked with ``git
archive``), so two versions of the kernels compare within one call: run
the script once per version, in turns.  Prints the card's name and power
limit, then one JSON object (with ``ptxas``'s registers and spills of
each kernel of the LM library), and writes it to
``chiprun_out/time_lm_kernels_<tag>.json``; exits non-zero when a kernel
disagrees with its plain version or no card is present.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (LM_TOL, PEAK_BYTES_PER_S, nvidia_smi,  # noqa: E402
                        ptxas_report, time_ms)

VVLS = (1, 2, 4, 8)
#: rmsnorm shapes (d, tokens) of the two serving paths
RMS_SHAPES = {"gemma2 prefill": (2304, 2 * 4608), "gemma2 decode": (2304, 2),
              "falcon-mamba prefill": (4096, 2 * 4096),
              "falcon-mamba decode": (4096, 2)}
#: elements of gemma2-2b's MLP activations at 2 prompts of 4608 tokens
EW_N = 2 * 4608 * 9216


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lm_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    import repro_torch
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import _build, lm, tdp_pointwise
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report(
        {"tdp_gathered_lm": _build.build_dir() / "tdp_gathered_lm.log"})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    problems: list[str] = []

    def row(name, spec, xs, consts, nbytes, library):
        want = torch_executor(launch_plan(spec, Target("cuda", vvl=1),
                                          consts=consts), xs)[0]
        ms, err = {}, 0.0
        for vvl in VVLS:
            plan = launch_plan(spec, Target("cuda", vvl=vvl), consts=consts)
            got = tdp_pointwise.cuda_execute(plan, xs)[0]
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            if not (torch.isfinite(got).all()
                    and torch.allclose(got, want, **LM_TOL)):
                problems.append(f"{name} vvl={vvl}: max |kernel - plain| = {e}")
            del got
            ms[vvl] = time_ms(lambda plan=plan: tdp_pointwise.cuda_execute(plan, xs))
        del want
        out = {"name": name, "shape": list(xs[0].shape), "ms_by_vvl": ms,
               "library_ms": time_ms(library) if library else None,
               "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
               "max_abs_err": err}
        print(json.dumps(out), file=sys.stderr, flush=True)
        return out

    rows = []
    for label, (d, n) in RMS_SHAPES.items():
        x = torch.randn(d, n, device=dev, generator=g)
        w = torch.randn(d, device=dev, generator=g)
        consts = {"weight": w, "eps": 1e-6, "scale_offset": 1.0}
        w1 = w + 1.0
        rows.append(row(f"rmsnorm {label}", lm.rmsnorm_spec(d), [x], consts,
                        8 * d * n + 4 * d,
                        lambda x=x, w1=w1: F.rms_norm(x.T, (x.shape[0],),
                                                      weight=w1, eps=1e-6)))
        del x
    u = 3.0 * torch.randn(1, EW_N, device=dev, generator=g)
    v = torch.randn(1, EW_N, device=dev, generator=g)
    rows.append(row("gated geglu", lm.gated_act_spec("geglu", True), [u, v],
                    {}, 12 * EW_N, None))
    del v
    rows.append(row("act gelu", lm.gated_act_spec("gelu", False), [u], {},
                    8 * EW_N, lambda: F.gelu(u, approximate="tanh")))
    result = {"tag": args.tag, "src": str(src), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0), "build_s": build_s,
              "ptxas": ptxas, "rows": rows, "problems": problems}
    print(json.dumps(result), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"time_lm_kernels_{args.tag}.json").write_text(
        json.dumps(result, indent=1))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
