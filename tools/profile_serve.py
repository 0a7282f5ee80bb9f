"""Where the time of serving an LM goes on the card.

    python3 tools/profile_serve.py [--arch gemma2-2b] [--batch 2] \
        [--prompt-len 4608] [--decode 16] [--src DIR] [--tag NAME]
    python3 tools/profile_serve.py --arch falcon-mamba-7b   # prompt 4096
    python3 tools/profile_serve.py --arch gemma3-27b  # 12 layers, 4096
    python3 tools/profile_serve.py --arch granite-moe-1b-a400m  # whole, 4096
    python3 tools/profile_serve.py --arch zamba2-2.7b  # whole, 4096
    python3 tools/profile_serve.py --arch deepseek-v3-671b  # 4 layers, 4096
    python3 tools/profile_serve.py --arch whisper-medium --batch 4  # 432

Builds ``--arch`` (gemma2-2b by default, or any arch of the port's
registry) at full width with seeded random float32 weights, at
``--layers`` (default: all, or ``chip_smoke.py``'s cut of gemma3, phi3 and
nemotron (phase 10) and deepseek-v3 (phase 13: 4 layers); a config's
multi-token prediction modules are not built, as serving never reads
them), with the reference launcher's audio frames, vision-stub and
M-RoPE inputs (``launch.serve.stub_inputs``) where the arch reads them,
serves ``--batch`` random prompts once to warm up, then traces the prefill and the
``--decode`` greedy decode steps with ``torch.profiler`` (two traces).  For
each it reports the host wall time (ending in ``torch.cuda.synchronize()``),
the device time summed over kernels, the device's busy share of the wall
time and of the traced span, and the device time per kernel name, split
into the port's own CUDA kernels (``flash_fwd_kernel``, ``ew_kernel``,
``rms_tiled_kernel``, ``rms_few_kernel``, ``mamba_kernel``) and PyTorch's (matrix products, copies, the plain decode
attention, the Mamba glue).  For a MoE arch the traces also split the MoE
layers' device time (``moe_ms_by_part``, per layer): ``route`` (router
product, softmax, top-k), ``dispatch`` (the stable sort, the pack's gather
and the unpack), ``bmm`` (the three batched expert products), ``gated``
(kernel 2a's SwiGLU over the packed rows) and ``combine`` (the weighted
sum over the K choices), from ``record_function`` ranges put around
``models.moe``'s functions for the traced runs only.  For an arch with
``mamba2`` layers (zamba2) they split a Mamba-2 mixer's device time the
same way (``mamba2_ms_by_part``, per ``mamba2`` layer): ``in_proj`` (the
x, gate, B, C and dt projections), ``conv`` (both causal convolutions),
``ssd_intra`` (the chunks' decay-masked Q×Q products), ``ssd_inter`` (the
chunk-boundary states and their outputs), ``gated_norm`` and
``out_proj_and_glue`` (the rest of the mixer: the out-projection, the
softplus, silu and reshapes), from ranges around ``models.ssm``'s
functions.  Under MLA (deepseek-v3) they split each layer's attention
(``mla_ms_by_part``, per layer): ``q_down_up`` (the query's down and up
projections), ``latent_norms`` (the query's and the latent's RMSNorms),
``kv_down_rope`` (the latent's and the shared rope key's projections, the
key's rotation), ``kv_expand`` (``w_uk``/``w_uv`` and the per-head keys),
``v_pad``, ``kernel4`` (the attention), ``rope_cat_slice_wo`` (the rest of
the expanded path: the query's rotation and concatenation, the output's
slice and ``wo``), ``absorbed`` (decode's attention over the latent cache)
and ``decode_glue_wo`` (the rest of a decode step: the cache writes and
``wo``), from ranges around ``models.mla``'s functions.  Needs one CUDA
card; prints the card's name and
power limit first and writes the full table to
``chiprun_out/profile_serve_<arch>[_<tag>].json``.  ``--src`` may point at
another checkout's ``src`` (one unpacked with ``git archive``), so two
versions compare within one call, run in turns.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_KERNELS = ("flash_fwd_kernel", "ew_kernel", "rms_tiled_kernel",
                "rms_few_kernel", "mamba_kernel")
#: the prompt length each arch is served at by default (chip_smoke.py's)
DEFAULT_PROMPT = {"gemma2-2b": 4608, "falcon-mamba-7b": 4096,
                  "gemma3-27b": 4096, "qwen2-vl-2b": 4096,
                  "phi3-medium-14b": 2048, "nemotron-4-15b": 2048,
                  "granite-moe-1b-a400m": 4096, "zamba2-2.7b": 4096,
                  "deepseek-v3-671b": 4096, "whisper-medium": 432}
#: the layers kept by default (chip_smoke.py's cuts, phases 10 and 13; 0 =
#: all)
DEFAULT_LAYERS = {"gemma3-27b": 12, "phi3-medium-14b": 10,
                  "nemotron-4-15b": 8, "deepseek-v3-671b": 4}


def summarize(prof, wall_s: float, per: int) -> dict:
    """Device time by kernel name (per ``per`` units of work) and the busy
    shares of one trace."""
    kernels = device_kernels(prof)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0.0
    port_us = sum(v for k, v in by_name.items()
                  if any(p in k for p in PORT_KERNELS))
    return {
        "wall_ms": wall_s * 1e3 / per,
        "device_ms": busy_us / 1e3 / per,
        "port_kernels_ms": port_us / 1e3 / per,
        "torch_ops_ms": (busy_us - port_us) / 1e3 / per,
        "device_busy_share_of_wall": busy_us / 1e6 / wall_s if wall_s else None,
        "device_busy_share_of_span": busy_us / span_us if span_us else None,
        "kernels_traced": len(kernels),
        "by_kernel_ms": {k: v / 1e3 / per for k, v in
                         sorted(by_name.items(), key=lambda kv: -kv[1])},
    }


#: functions traced as ranges, by module (``models.moe``, ``models.ssm``)
#: and range prefix, and the part each range's device time goes to: for
#: the MoE the experts range's products to ``bmm``, its gated range to
#: ``gated``, the rest to ``dispatch``; for a Mamba-2 mixer what no inner
#: range holds to ``out_proj_and_glue``
RANGES = {"moe": {"_route": "route", "_apply_experts_capacity": "dispatch",
                  "grouped_matmul": "bmm", "_act": "gated",
                  "_combine": "combine"},
          "ssd": {"mamba2_mixer": "out_proj_and_glue",
                  "_mamba2_project": "in_proj", "_causal_conv": "conv",
                  "_ssd_intra": "ssd_intra", "_ssd_inter": "ssd_inter",
                  "_gated_rmsnorm": "gated_norm"},
          "mla": {"mla_full": "rope_cat_slice_wo",
                  "mla_decode": "decode_glue_wo", "_project_q": "q_down_up",
                  "_rms": "latent_norms", "_latent_kv": "kv_down_rope",
                  "_expand_kv": "kv_expand", "_pad_v": "v_pad",
                  "_attend": "kernel4", "_absorbed": "absorbed"}}
#: matrix products by kernel name (cuBLAS / CUTLASS)
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma")
#: ranges searched back from a kernel for the one holding it (the
#: expanded MLA path runs seven inner ranges)
LOOK_BACK = 10


def traced_ranges(module, prefix: str):
    """Wraps ``RANGES[prefix]``' functions of ``module`` in
    ``record_function`` ranges named ``<prefix>.<part>``; returns a
    function that restores them."""
    from torch.profiler import record_function
    table = RANGES[prefix]
    saved = {name: getattr(module, name) for name in table}

    def ranged(fn, label):
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner
    for name, part in table.items():
        setattr(module, name, ranged(saved[name], f"{prefix}.{part}"))
    return lambda: [setattr(module, n, f) for n, f in saved.items()]


def device_kernels(prof) -> list:
    """The trace's device kernels: its device events but the traced
    ranges' own (a ``record_function`` range also leaves an event on the
    device timeline, spanning its kernels and the gaps between them)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(tuple(f"{p}." for p in RANGES))]


def range_split(prof, per: int, prefix: str) -> dict:
    """Device ms (per ``per`` units of work) of the kernels inside the
    ``<prefix>.*`` ranges on the device timeline, each kernel given to its
    innermost range's part (the ranges nest two deep: the MoE's ``gated``
    inside the experts', a mixer's parts inside the mixer's), a matrix
    product inside the MoE experts' range to ``bmm``.  The innermost range
    holding a kernel is the latest to start before it that also ends
    after it; a mixer runs six inner ranges and MLA's expanded path seven,
    so the search looks back ``LOOK_BACK`` ranges."""
    import bisect
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(prefix) + 1:]) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.startswith(prefix + "."))
    starts = [r[0] for r in ranges]
    parts = {p: 0.0 for p in dict.fromkeys(RANGES[prefix].values())}
    for k in device_kernels(prof):
        t0, t1 = k.time_range.start, k.time_range.end
        i = bisect.bisect_right(starts, t0) - 1
        for j in range(i, max(i - LOOK_BACK, -1), -1):
            if ranges[j][0] <= t0 and t1 <= ranges[j][1]:
                part = ranges[j][2]
                break
        else:
            continue
        if part == "dispatch" and any(s in k.name.lower() for s in GEMM_NAMES):
            part = "bmm"
        parts[part] += k.time_range.elapsed_us()
    return {k: v / 1e3 / per for k, v in parts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(DEFAULT_PROMPT))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.prompt_len is None:
        args.prompt_len = DEFAULT_PROMPT[args.arch]
    if args.layers is None:
        args.layers = DEFAULT_LAYERS.get(args.arch, 0)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device is available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch import configs
    from repro_torch.models import params as model_params
    from repro_torch.models.context import ExecContext
    from repro_torch.runtime.steps import build_serve_steps
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = configs.get_config(args.arch)
    if args.layers:
        cfg = configs.first_layers(cfg, args.layers)
    cfg = dataclasses.replace(cfg, mtp_depth=0)
    params = model_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)}
    if cfg.vision_stub or cfg.pos_embed == "mrope" or cfg.is_encdec:
        from repro_torch.launch.serve import stub_inputs
        batch.update(stub_inputs(cfg, args.batch, args.prompt_len, rng, dev))
    pre, dec = build_serve_steps(cfg, ExecContext(backend="cuda"),
                                 max_len=args.prompt_len + args.decode)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def decode_all(tok, caches, length):
        for _ in range(args.decode):
            tok, caches, length, _ = dec(params, tok, caches, length)
        return tok

    def trace():
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    from repro_torch.models import moe, ssm
    # (range prefix, module, the result's key, the layers it is per)
    split = [(prefix, module, key, cfg.layer_program.count(btype))
             for prefix, module, key, btype in (
                 ("moe", moe, "moe_ms_by_part", "attn_moe"),
                 ("ssd", ssm, "mamba2_ms_by_part", "mamba2"))
             if btype in cfg.layer_program]
    if cfg.mla is not None:
        from repro_torch.models import mla
        split.append(("mla", mla, "mla_ms_by_part", cfg.n_layers))
    with torch.inference_mode():
        tok, caches, length, _ = pre(params, batch)   # warm-up
        decode_all(tok, caches, length)
        restores = [traced_ranges(module, prefix)
                    for prefix, module, _, _ in split]
        with trace() as p_pre:
            (tok, caches, length, _), t_pre = timed(
                lambda: pre(params, batch))
        with trace() as p_dec:
            _, t_dec = timed(lambda: decode_all(tok, caches, length))
        for restore in restores:
            restore()
    traced = {"prefill": (p_pre, t_pre), "decode": (p_dec, t_dec)}
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "src": str(src), "tag": args.tag, "arch": args.arch,
              "layers": cfg.n_layers,
              "batch": args.batch, "prompt_len": args.prompt_len,
              "decode_steps": args.decode,
              "prefill": summarize(*traced["prefill"], per=1),
              "decode_per_step": summarize(*traced["decode"], per=args.decode)}
    for prefix, _, key, n in split:
        result["prefill"][key] = range_split(p_pre, n, prefix)
        result["decode_per_step"][key] = range_split(p_dec, args.decode * n,
                                                     prefix)
    for phase in ("prefill", "decode_per_step"):
        row = result[phase]
        top = dict(list(row["by_kernel_ms"].items())[:8])
        print(json.dumps({"phase": phase, **{k: v for k, v in row.items()
                                              if k != "by_kernel_ms"},
                          "top_kernels_ms": top}), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    tag = f"_{args.tag}" if args.tag else ""
    (ROOT / "chiprun_out" / f"profile_serve_{args.arch}{tag}.json").write_text(
        json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
