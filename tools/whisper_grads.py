"""Step 1's gradients of whisper-medium on the card, leaf by leaf, by route.

    python3 tools/whisper_grads.py [--out chiprun_out/whisper_grads.json]
    python3 tools/whisper_grads.py --smoke --device cpu   # a rehearsal
    python3 tools/whisper_grads.py --bias-only --src DIR  # another checkout

Builds whisper-medium whole from seeded random float32 weights (as
``chip_smoke.py``'s phase 14 does), takes its first training batch (8 ×
448 tokens of the successor stream, seed 0, and 8 × 1500 random frames
from the step's seed) and computes the loss and its gradient the way the
train step does (two strided microbatches, block remat) on these routes:

* ``cuda``: the kernels (kernel 4 and kernel 2a's GELU);
* ``torch``: the plain path, the route every other is held to;
* ``torch_again``: the plain path once more (is it reproducible?);
* ``flash_only``: the kernels' route with the GELU's plain version;
* ``act_only``: the kernels' route with kernel 4's plain version;
* ``torch_ulp_attn``: the plain path with every attention output moved by
  about one float32 rounding (each element times 1 ± 2⁻²³, the sign from
  its lowest bit): how far a rounding of the attention moves each leaf;
* ``torch_chunked``: the plain path on the chunked attention oracle (128
  query rows at a time, its backward the flash-style recompute the kernel's
  route runs): another float32 order of the same sums;
* ``cuda_plain_out_bwd``: the kernels' route whose attention backward
  (``ref._chunk_bwd``) takes the plain chunked forward's output in place
  of the kernel's (the term D = Σ dO·O).

For each route against ``torch`` it prints one JSON line: the loss's and
the global gradient norm's relative differences, each leaf group's worst
and median relative difference of its leaves' gradient norms, and the
worst leaves.  TF32 stays off for the matrix products, as in
``chip_smoke.py``.  ``--smoke --device cpu`` runs the reduced config on 4
× 12 tokens on the CPU, where every route is the plain path: a rehearsal.

First it measures kernel 4's drift at the encoder's shape (4, 16 / 16,
1500 × 1500, Dh 64, non-causal; q, k, v standard normal, seed 0) against
attention in float64: the signed drift Σ (o − o₆₄)·sign(o₆₄) / Σ |o₆₄|
(negative: toward zero) and the mean |o − o₆₄| / mean |o₆₄|, beside the
plain version's (float32).  ``--bias-only --src DIR`` measures only that,
with the kernels of the ``repro_torch`` package under ``DIR`` (another
checkout's ``src``), so a parent checkout can be measured in the same
call.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUTES = ("cuda", "torch", "torch_again", "flash_only", "act_only",
          "torch_ulp_attn", "torch_chunked", "cuda_plain_out_bwd")
BATCH, SEQ, ACCUM = 8, 448, 2


def leaf_items(tree, prefix=""):
    """(path, tensor) of ``tree``'s leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def group_of(path: str) -> str:
    """The leaf's group: the table, the stack, the sub-layer."""
    parts = path.strip("/").split("/")
    if parts[0] in ("embed", "pos_embed", "final_norm"):
        return parts[0]
    if parts[0] == "encoder":
        if parts[1] != "layers":
            return f"encoder.{parts[1]}"
        return f"encoder.{parts[3]}"
    return f"decoder.{parts[2]}"


def kernel_drift() -> dict:
    """Kernel 4 and the plain version against float64 attention at the
    encoder's shape (the module docstring)."""
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 16, 1500, 64, device="cuda", generator=g)
               for _ in range(3))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * 64 ** -0.5
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
    del s
    out = {}
    for name, o in (("kernel", flash_attention.flash_attention(
            q, k, v, causal=False)), ("plain", ref.attention_ref(
                q, k, v, causal=False))):
        err = o.double() - want
        out[name] = {
            "signed_drift": float((err * want.sign()).sum()
                                  / want.abs().sum()),
            "mean_abs_err_rel": float(err.abs().mean() / want.abs().mean()),
            "max_abs_err": float(err.abs().max())}
    return out


@contextlib.contextmanager
def patched(route, ops, ref):
    """The ops module's entry points as ``route`` wants them."""
    flash, act, bwd = ops.flash_attention, ops.gated_act, ref._chunk_bwd
    if route == "flash_only":
        ops.gated_act = lambda *a, **kw: act(*a, **{**kw, "target": "torch"})
    elif route == "act_only":
        ops.flash_attention = lambda *a, **kw: flash(
            *a, **{**kw, "target": "torch"})
    elif route == "torch_ulp_attn":
        def moved(*a, **kw):
            # the sign from the output's lowest bit: the same in the
            # forward pass and in remat's recompute
            o = flash(*a, **kw)
            sign = (o.detach().view(torch.int32) & 1) * 2 - 1
            return o * (1.0 + sign * 2.0 ** -23)
        ops.flash_attention = moved
    elif route == "cuda_plain_out_bwd":
        def plain_out_bwd(cfg, res, dout):
            q, k, v, _, lse = res
            return bwd(cfg, (q, k, v, ref._chunk_fwd(q, k, v, cfg)[0], lse),
                       dout)
        ref._chunk_bwd = plain_out_bwd
    try:
        yield
    finally:
        ops.flash_attention, ops.gated_act = flash, act
        ref._chunk_bwd = bwd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "whisper_grads.json"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--bias-only", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("whisper_grads: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import repro_torch
    print(f"repro_torch from {repro_torch.__file__}", flush=True)
    if args.device == "cuda":
        bias = kernel_drift()
        print(json.dumps({"kernel4_drift": bias}), flush=True)
        if args.bias_only:
            return 0
    from repro_torch import configs
    from repro_torch.data import SyntheticConfig, make_batch_loader
    from repro_torch.kernels import ops, ref
    from repro_torch.models import params as model_params
    from repro_torch.models.context import ExecContext
    from repro_torch.runtime.steps import TrainHParams, _metrics_and_grads

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = (configs.get_smoke if args.smoke else configs.get_config)(
        "whisper-medium")
    b, s = (4, 12) if args.smoke else (BATCH, SEQ)
    params = model_params.trainable(model_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    batch = make_batch_loader(SyntheticConfig(cfg.vocab_size, s, b, seed=0),
                              device=dev)(0)
    batch["audio_embed"] = torch.randn(
        b, cfg.encoder.n_frames, cfg.d_model, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1000))
    hp = TrainHParams(grad_accum=ACCUM)
    runs = {}
    for route in ROUTES:
        backend = "torch" if route.startswith("torch") else "cuda"
        impl = "chunked" if route == "torch_chunked" else "ref"
        fn = _metrics_and_grads(cfg, ExecContext(
            backend=backend, remat="block", attn_impl=impl), hp)
        with patched(route, ops, ref):
            metrics, grads = fn(params, batch)
        items = list(leaf_items(grads))
        runs[route] = {"loss": float(metrics["loss"]),
                       "names": [n for n, _ in items],
                       "norms": torch.stack([torch.linalg.vector_norm(g)
                                             for _, g in items]).tolist()}
        del grads, items
        torch.cuda.empty_cache()
    base = runs["torch"]

    def global_norm(r):
        return sum(x * x for x in r["norms"]) ** 0.5

    out = {}
    for route in ROUTES:
        if route == "torch":
            continue
        r = runs[route]
        rel = [abs(a - b) / b if b else abs(a)
               for a, b in zip(r["norms"], base["norms"])]
        groups: dict = {}
        for name, x in zip(base["names"], rel):
            groups.setdefault(group_of(name), []).append(x)
        worst = sorted(range(len(rel)), key=lambda i: -rel[i])[:10]
        out[route] = {
            "loss_rel_diff": abs(r["loss"] - base["loss"]) / base["loss"],
            "grad_norm_rel_diff": abs(global_norm(r) - global_norm(base))
            / global_norm(base),
            "leaf_rel_diff_worst": max(rel),
            "leaf_rel_diff_median": statistics.median(rel),
            "groups": {g: {"worst": max(v), "median": statistics.median(v),
                           "leaves": len(v)} for g, v in sorted(
                               groups.items())},
            "worst_leaves": [{"leaf": base["names"][i], "rel_diff": rel[i],
                              "norm": base["norms"][i]} for i in worst]}
        print(json.dumps({route: out[route]}), flush=True)
    out["losses"] = {k: v["loss"] for k, v in runs.items()}
    out["global_norms"] = {k: global_norm(v) for k, v in runs.items()}
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
