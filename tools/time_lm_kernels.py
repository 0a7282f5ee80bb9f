"""Time the LM kernels (rmsnorm, gated, act, mamba, flash) on one card.

    python3 tools/time_lm_kernels.py [--src DIR] [--tag NAME] \
        [--kernels rmsnorm,gated,act,mamba,flash,flash128,flash80,flash192,
                   flash64w]

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
  2 × 4608 × 9216 MLP activations;
* ``mamba``: one falcon-mamba-7b layer's selective scan, both batch rows
  (2, 4096, 8192, N 16), through ``ops.mamba_scan`` at each VVL (the public
  entry, which any version of the package has, however many launches it
  makes of it), held to the step oracle; bound: the larger of its bytes and
  its L·n·N exponentials on the SFUs;
* ``flash``: ``flash_attention`` at gemma2-2b's prefill shape (2, 8, 4,
  4608, 4608, 256), its local (window 4096, softcap 50), global (softcap
  50) and plain causal layers, the last beside
  ``scaled_dot_product_attention``; bounds: float32 on the CUDA cores and
  TF32 on the tensor cores (one TF32 product and 3xTF32);
* ``flash128``: ``flash_attention`` at gemma3-27b's prefill (2, 32 / 16,
  4096, Dh 128), causal, no softcap: its local layers (window 1024) and
  its global ones, each beside SDPA (a band mask for the window,
  ``is_causal`` for the global);
* ``flash80``: ``flash_attention`` at zamba2-2.7b's shared block (2, 32,
  32, 4096, 4096, Dh 80), causal, beside SDPA and beside the route that
  pads q, k and v with zeros to Dh 128 and slices the output (timed for
  the record: no path of the port takes it).  A version of the package
  without the Dh 80 instantiation raises; leave ``flash80`` out of
  ``--kernels`` for it.
* ``flash192``: ``flash_attention`` at deepseek-v3-671b's MLA prefill (2,
  128, 128, 4096, Dh 192), causal, V zero-padded from 128 as the model
  pads it, held to the chunked plain version (the whole-score one would
  hold three 17.2 GB tensors), beside SDPA in float32 on the same padded
  inputs, beside the
  3xTF32 bounds with V padded and unpadded, and the V pad copy and the
  output slice at the model's (B, S, H, ·) layouts timed.  A version of
  the package without the Dh 192 instantiation raises; leave ``flash192``
  out of ``--kernels`` for it.
* ``flash64w``: ``flash_attention`` at whisper-medium's three attentions
  at Dh 64 (``chip_smoke.WHISPER_ATTN_ROWS``: the encoder's (4, 16 / 16,
  1500 × 1500) and the cross-attention's (4, 16 / 16, 432 × 1500), not
  causal, the decoder's (4, 16 / 16, 432 × 432), causal), each beside
  SDPA (``is_causal`` for the causal one only).

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
from chip_smoke import (LM_TOL, PEAK_BYTES_PER_S,  # noqa: E402
                        PEAK_SFU_PER_S, PEAK_TF32_PER_S, WHISPER_ATTN_ROWS,
                        attn_bound, nvidia_smi, ptxas_report, time_ms)

VVLS = (1, 2, 4, 8)
#: rmsnorm shapes (d, tokens) of the two serving paths
RMS_SHAPES = {"gemma2 prefill": (2304, 2 * 4608), "gemma2 decode": (2304, 2),
              "falcon-mamba prefill": (4096, 2 * 4096),
              "falcon-mamba decode": (4096, 2)}
#: elements of gemma2-2b's MLP activations at 2 prompts of 4608 tokens
EW_N = 2 * 4608 * 9216
#: falcon-mamba-7b's scan per layer: (batch, L, d_inner, N)
MAMBA_SHAPE = (2, 4096, 8192, 16)
#: gemma2-2b's prefill attention: (B, Hq, Hkv, S, Dh), window, softcap
ATTN_SHAPE = (2, 8, 4, 4608, 256)
ATTN_VARIANTS = {"local": (4096, 50.0), "attn": (0, 50.0), "causal": (0, 0.0)}
#: zamba2-2.7b's shared attention: (B, Hq, Hkv, S, Dh), causal, and the
#: head_dim the padded route pads to
ATTN80_SHAPE, PAD_DH = (2, 32, 32, 4096, 80), 128
#: deepseek-v3-671b's MLA prefill: (B, Hq, Hkv, S, Dh) and V's own width
ATTN192_SHAPE, V192 = (2, 128, 128, 4096, 192), 128
#: gemma3-27b's prefill attention: (B, Hq, Hkv, S, Dh), its local window
ATTN128_SHAPE, WINDOW128 = (2, 32, 16, 4096, 128), 1024
KERNELS = ("rmsnorm", "gated", "act", "mamba", "flash", "flash128",
           "flash80", "flash192", "flash64w")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args(argv)
    todo = set(args.kernels.split(","))
    if todo - set(KERNELS):
        ap.error(f"--kernels takes some of {KERNELS}")
    if not torch.cuda.is_available():
        print("time_lm_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    import repro_torch
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import _build, flash_attention, lm, ops, ref
    from repro_torch.kernels import tdp_pointwise
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report(
        {lib: _build.build_dir() / f"{lib}.log"
         for lib in ("tdp_gathered_lm", "flash_attention")})
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
        if "rmsnorm" not in todo:
            break
        x = torch.randn(d, n, device=dev, generator=g)
        w = torch.randn(d, device=dev, generator=g)
        consts = {"weight": w, "eps": 1e-6, "scale_offset": 1.0}
        w1 = w + 1.0
        rows.append(row(f"rmsnorm {label}", lm.rmsnorm_spec(d), [x], consts,
                        8 * d * n + 4 * d,
                        lambda x=x, w1=w1: F.rms_norm(x.T, (x.shape[0],),
                                                      weight=w1, eps=1e-6)))
        del x
    if todo & {"gated", "act"}:
        u = 3.0 * torch.randn(1, EW_N, device=dev, generator=g)
        v = torch.randn(1, EW_N, device=dev, generator=g)
        if "gated" in todo:
            rows.append(row("gated geglu", lm.gated_act_spec("geglu", True),
                            [u, v], {}, 12 * EW_N, None))
        del v
        if "act" in todo:
            rows.append(row("act gelu", lm.gated_act_spec("gelu", False), [u],
                            {}, 8 * EW_N, lambda: F.gelu(u, approximate="tanh")))
        del u
    torch.cuda.empty_cache()

    if "mamba" in todo:
        b, length, n, nstate = MAMBA_SHAPE
        x = torch.randn(b, length, n, device=dev, generator=g)
        dt = F.softplus(torch.randn(b, length, n, device=dev, generator=g))
        bb, cc = (torch.randn(b, length, nstate, device=dev, generator=g)
                  for _ in range(2))
        a = -torch.exp(torch.randn(n, nstate, device=dev, generator=g))
        d = torch.ones(n, device=dev)
        t0 = time.perf_counter()
        want = ref.mamba_scan_ref(x, dt, bb, cc, a, d)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        ms, err = {}, 0.0
        for vvl in VVLS:
            def call(vvl=vvl):
                return ops.mamba_scan(x, dt, bb, cc, a, d, vvl=vvl)
            before = tdp_pointwise.launches["mamba"]
            got = call()
            torch.cuda.synchronize()
            calls = tdp_pointwise.launches["mamba"] - before
            e = max(float((o - w).abs().max()) for o, w in zip(got, want))
            err = max(err, e)
            if not all(torch.isfinite(o).all() and torch.allclose(o, w, **LM_TOL)
                       for o, w in zip(got, want)):
                problems.append(f"mamba vvl={vvl}: max |kernel - plain| = {e}")
            del got
            ms[vvl] = time_ms(call)
        nbytes = 4 * (3 * b * length * n + (b + 1) * nstate * n + n
                      + 2 * b * length * nstate)
        out = {"name": "mamba layer (ops.mamba_scan)",
               "shape": list(MAMBA_SHAPE), "ms_by_vvl": ms,
               "launches_per_layer": calls,
               "bound_ms": max(nbytes / PEAK_BYTES_PER_S,
                               b * length * n * nstate / PEAK_SFU_PER_S) * 1e3,
               "plain_oracle_wall_s": plain_s, "library_ms": None,
               "max_abs_err": err}
        print(json.dumps(out), file=sys.stderr, flush=True)
        rows.append(out)
        del x, dt, bb, cc, a, d, want
        torch.cuda.empty_cache()

    if "flash" in todo:
        b, hq, hkv, s_len, dh = ATTN_SHAPE
        q = torch.randn(b, hq, s_len, dh, device=dev, generator=g)
        k, v = (torch.randn(b, hkv, s_len, dh, device=dev, generator=g)
                for _ in range(2))
        for variant, (window, softcap) in ATTN_VARIANTS.items():
            kw = dict(causal=True, window=window, softcap=softcap)
            want = ref.attention_ref(q, k, v, **kw)
            out = {"name": f"flash {variant}",
                   "shape": [b, hq, hkv, s_len, s_len, dh],
                   "window": window, "softcap": softcap,
                   "plain_ms": time_ms(lambda kw=kw: ref.attention_ref(
                       q, k, v, **kw), reps=5),
                   "bound_fp32_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                               True, window)[0],
                   "bound_tf32x1_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                                 True, window, split=1)[0],
                   "bound_tf32x3_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                                 True, window, split=3)[0]}

            def call(kw=kw):
                return flash_attention.flash_attention(q, k, v, **kw)
            got = call()
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            out["max_abs_err"] = e
            out["within_bar"] = bool(torch.allclose(got, want, **LM_TOL))
            if not out["within_bar"]:
                problems.append(f"flash {variant}: max |kernel - plain| = {e}")
            del got
            out["ms"] = time_ms(call)
            out["library_ms"] = (time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
                if variant == "causal" else None)
            print(json.dumps(out), file=sys.stderr, flush=True)
            rows.append(out)
            del want
            torch.cuda.empty_cache()
        del q, k, v

    if "flash128" in todo:
        b, hq, hkv, s_len, dh = ATTN128_SHAPE
        q = torch.randn(b, hq, s_len, dh, device=dev, generator=g)
        k, v = (torch.randn(b, hkv, s_len, dh, device=dev, generator=g)
                for _ in range(2))
        i = torch.arange(s_len, device=dev)
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - WINDOW128)
        for variant, window in (("local", WINDOW128), ("global", 0)):
            want = ref.attention_ref(q, k, v, causal=True, window=window)

            def call(window=window):
                return flash_attention.flash_attention(q, k, v, causal=True,
                                                       window=window)
            got = call()
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            if not torch.allclose(got, want, **LM_TOL):
                problems.append(f"flash gemma3 {variant}: max |kernel - "
                                f"plain| = {e}")
            del got, want
            lib = ((lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True)) if window else
                (lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)))
            out = {"name": f"flash gemma3 {variant} (Dh 128)",
                   "shape": [b, hq, hkv, s_len, s_len, dh], "window": window,
                   "max_abs_err": e, "ms": time_ms(call),
                   "library_ms": time_ms(lib),
                   "bound_tf32x3_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                                 True, window, split=3)[0]}
            print(json.dumps(out), file=sys.stderr, flush=True)
            rows.append(out)
            torch.cuda.empty_cache()
        del q, k, v, band

    if "flash80" in todo:
        b, hq, hkv, s_len, dh = ATTN80_SHAPE
        q = torch.randn(b, hq, s_len, dh, device=dev, generator=g)
        k, v = (torch.randn(b, hkv, s_len, dh, device=dev, generator=g)
                for _ in range(2))

        def call():
            return flash_attention.flash_attention(q, k, v, causal=True)

        def padded():
            def pad(t):
                return F.pad(t, (0, PAD_DH - dh))
            return flash_attention.flash_attention(
                pad(q), pad(k), pad(v), causal=True,
                scale=dh ** -0.5)[..., :dh]
        want = ref.attention_ref(q, k, v, causal=True)
        out = {"name": "flash zamba2 (Dh 80)",
               "shape": [b, hq, hkv, s_len, s_len, dh],
               "plain_ms": time_ms(lambda: ref.attention_ref(
                   q, k, v, causal=True), reps=5),
               "bound_tf32x3_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                             True, 0, split=3)[0],
               "bound_fp32_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                           True, 0)[0],
               "padded_bound_tf32x3_ms": attn_bound(
                   b, hq, hkv, s_len, s_len, PAD_DH, True, 0, split=3)[0]}
        for key, fn in (("max_abs_err", call),
                        ("padded_max_abs_err", padded)):
            got = fn()
            torch.cuda.synchronize()
            out[key] = float((got - want).abs().max())
            if not torch.allclose(got, want, **LM_TOL):
                problems.append(f"flash Dh 80 ({key}): max |kernel - plain| "
                                f"= {out[key]}")
            del got
        out["ms"] = time_ms(call)
        out["padded_ms"] = time_ms(padded)
        out["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        print(json.dumps(out), file=sys.stderr, flush=True)
        rows.append(out)
        del q, k, v, want
        torch.cuda.empty_cache()
    if "flash192" in todo:
        b, hq, hkv, s_len, dh = ATTN192_SHAPE
        q = torch.randn(b, hq, s_len, dh, device=dev, generator=g)
        k = torch.randn(b, hkv, s_len, dh, device=dev, generator=g)
        v = F.pad(torch.randn(b, hkv, s_len, V192, device=dev, generator=g),
                  (0, dh - V192))

        def call():
            return flash_attention.flash_attention(q, k, v, causal=True)
        want = ref.attention_chunked_ref(q, k, v, causal=True)
        got = call()
        torch.cuda.synchronize()
        pairs = b * hq * s_len * (s_len + 1) // 2
        out = {"name": "flash deepseek (Dh 192, V padded from 128)",
               "shape": [b, hq, hkv, s_len, s_len, dh], "v_dim": V192,
               "max_abs_err": float((got - want).abs().max()),
               "padded_dims_of_o_zero": bool((got[..., V192:] == 0).all()),
               "plain_ms": time_ms(lambda: ref.attention_chunked_ref(
                   q, k, v, causal=True), reps=3, warmup=1),
               "bound_tf32x3_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                             True, 0, split=3)[0],
               "bound_tf32x3_v_unpadded_ms": 3 * pairs * (2 * dh + 2 * V192)
               / PEAK_TF32_PER_S * 1e3,
               "bound_fp32_ms": attn_bound(b, hq, hkv, s_len, s_len, dh,
                                           True, 0)[0]}
        if not (torch.allclose(got, want, **LM_TOL)
                and out["padded_dims_of_o_zero"]):
            problems.append(f"flash Dh 192: max |kernel - plain| = "
                            f"{out['max_abs_err']}, padded dimensions of O "
                            f"zero: {out['padded_dims_of_o_zero']}")
        del got, want
        torch.cuda.empty_cache()
        out["ms"] = time_ms(call)
        out["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        del q, k, v
        torch.cuda.empty_cache()
        vm = torch.randn(b, s_len, hkv, V192, device=dev, generator=g)
        om = torch.randn(b, s_len, hq, dh, device=dev, generator=g)
        out["v_pad_ms"] = time_ms(lambda: F.pad(vm, (0, dh - V192)))
        out["o_slice_ms"] = time_ms(
            lambda: om[..., :V192].reshape(b, s_len, -1).contiguous())
        print(json.dumps(out), file=sys.stderr, flush=True)
        rows.append(out)
        del vm, om
        torch.cuda.empty_cache()
    if "flash64w" in todo:
        for tag, b, hq, hkv, sq, sk, causal in WHISPER_ATTN_ROWS:
            q = torch.randn(b, hq, sq, 64, device=dev, generator=g)
            k, v = (torch.randn(b, hkv, sk, 64, device=dev, generator=g)
                    for _ in range(2))

            def call(causal=causal):
                return flash_attention.flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            got = call()
            torch.cuda.synchronize()
            out = {"name": f"flash {tag}", "shape": [b, hq, hkv, sq, sk, 64],
                   "causal": causal,
                   "max_abs_err": float((got - want).abs().max()),
                   "bound_tf32x3_ms": attn_bound(b, hq, hkv, sq, sk, 64,
                                                 causal, 0, split=3)[0]}
            if not torch.allclose(got, want, **LM_TOL):
                problems.append(f"flash {tag}: max |kernel - plain| = "
                                f"{out['max_abs_err']}")
            del got, want
            out["ms"] = time_ms(call)
            out["library_ms"] = time_ms(
                lambda causal=causal: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal))
            print(json.dumps(out), file=sys.stderr, flush=True)
            rows.append(out)
            del q, k, v
            torch.cuda.empty_cache()
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
