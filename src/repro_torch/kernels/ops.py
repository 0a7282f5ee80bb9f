"""Public wrappers for the kernels, Target-dispatched.

Every op takes a ``target=`` (a :class:`~repro_torch.core.Target` or an
executor name) and a ``device=``.  With no ``device=`` the op runs on
``cuda`` and raises ``RuntimeError`` when no card is present; it never
carries on quietly on the CPU.  The default target follows the device:

* ``lb_collision`` — ``"cuda"`` (the dedicated kernel ``csrc/lb_collision.cu``)
  on the card, ``"torch"`` (the plain oracle) on the CPU;
* ``lb_fused_step`` — ``"cuda_windowed"`` on the card, ``"torch"`` on the
  CPU;
* ``rmsnorm``, ``gated_act``, ``mamba_scan`` — ``"cuda"`` (the site-kernel
  executor running the LM site functions of ``csrc/lm_sites.cuh``) on the
  card, ``"torch"`` on the CPU, both through ``tdp.launch``;
* ``flash_attention`` — ``"cuda"`` (``csrc/flash_attention.cu``) on the card,
  ``"torch"`` (:func:`~repro_torch.kernels.ref.attention_ref`) on the CPU.

A CUDA target resolves ``vvl=None`` to 1 site per thread.

Gradients.  The kernels write their outputs through raw pointers, so on
their own they return tensors with no ``grad_fn``.  Under the ``"cuda"``
target the four LM ops therefore run their kernel inside a
``torch.autograd.Function`` whenever grad mode is on and an input
requires a gradient (``_RMSNormFn``, ``_GatedActFn``, ``_MambaScanFn``,
``_FlashFn``): the forward is the kernel, the backward plain PyTorch (the
reference has no backward kernel: its Pallas calls have no ``custom_vjp``
and its flash backward is plain jnp).  On CPU tensors the forward is the
plain version, so the backward runs there too.  Under ``"torch"`` the ops
are plain PyTorch and autograd follows them as they are.  On bfloat16
inputs the backward recomputes the plain version on them (its float32
casts are the reference's) and returns each gradient in its input's
dtype; flash's in float32 from the kernel's float32 ``lse``, rounded once.
"""
from __future__ import annotations

import torch

from repro_torch.core import Target, as_target
from repro_torch.core.api import _normalize_halo
from repro_torch.core.api import launch as _tdp_launch

from . import flash_attention as _fa
from . import lb_collision as _lb
from . import lm as _lm
from . import ref as _ref


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def _op_target(target, vvl, default: str) -> Target:
    return as_target(target if target is not None else default, vvl=vvl)


def lb_collision(f, g, phi, gradphi, del2phi, *, target=None, vvl=None,
                 device=None, **phys):
    """Binary collision over SoA arrays ``(ncomp, nsites)`` (tensors or
    numpy arrays, moved to ``device``).  Returns ``(f', g')``."""
    dev = resolve_device(device)
    t = _op_target(target, vvl, "cuda" if dev.type == "cuda" else "torch")
    args = [torch.as_tensor(x, device=dev)
            for x in (f, g, phi, gradphi, del2phi)]
    if t.executor == "torch":
        return _ref.lb_collision_ref(*args, **phys)
    if t.executor == "cuda":
        return _lb.lb_collision(*args, vvl=t.vvl, **phys)
    raise ValueError(f"lb_collision runs under the 'torch' or 'cuda' "
                     f"executor, got {t.executor!r}")


def lb_fused_step(f, g, *, grid_shape, halo=0, mode="one_launch",
                  target=None, vvl=None, device=None, **phys):
    """One fused stream→gradient→collide step over SoA arrays (19, nsites).

    ``f``/``g`` are *pre-stream* populations over ``grid_shape`` (extended
    by ``halo`` caller-filled ghost planes per dimension where non-zero;
    0 → fully periodic).  Returns the next pre-stream state over the
    interior.  ``mode`` is ``"one_launch"`` (one stencil launch over the
    radius-2 composed g-neighbourhood) or ``"two_launch"`` (a streamed-φ
    launch, then a radius-1 stream/collide launch).
    """
    from repro_torch.lb import programs as _lbp   # lazy: avoids kernels↔lb cycle

    dev = resolve_device(device)
    t = _op_target(target, vvl,
                   "cuda_windowed" if dev.type == "cuda" else "torch")
    f = torch.as_tensor(f, device=dev)
    g = torch.as_tensor(g, device=dev)
    shape = tuple(int(s) for s in grid_shape)
    h = _normalize_halo(halo, len(shape))
    prog = _lbp.fused_program(
        mode, _lbp.collision_consts(dtype=_lbp.consts_dtype(f.dtype), **phys))
    ext = tuple(s + 2 * hh for s, hh in zip(shape, h))
    out = prog.execute(t, {"f": f.reshape(_lb.NVEL, *ext),
                           "g": g.reshape(_lb.NVEL, *ext)},
                       grid_shape=shape, halo=h)
    return (out["f"].reshape(_lb.NVEL, -1),
            out["g"].reshape(_lb.NVEL, -1))


def _lm_target(target, vvl, dev) -> Target:
    t = _op_target(target, vvl, "cuda" if dev.type == "cuda" else "torch")
    if t.executor not in ("torch", "cuda"):
        raise ValueError(f"the LM ops run under the 'torch' or 'cuda' "
                         f"executor, got {t.executor!r}")
    return t


def rmsnorm(x, weight, *, target=None, vvl=None, eps=1e-6, scale_offset=0.0,
            device=None):
    """RMSNorm of ``x: (tokens, d)`` with ``weight: (d,)`` through
    ``tdp.launch`` — site = token, features on the component axis
    (:func:`repro_torch.kernels.lm.rmsnorm_spec`); ``x`` goes in as the
    contiguous ``(d, tokens)`` SoA field and the result comes back as its
    ``(tokens, d)`` view.  ``scale_offset=1.0`` gives the Gemma convention
    ``x · rms · (1 + w)``.  The weight is a dynamic const: a tensor on the
    launch's device, never copied to the host."""
    dev = resolve_device(device)
    t = _lm_target(target, vvl, dev)
    x = torch.as_tensor(x, device=dev)
    weight = torch.as_tensor(weight, device=dev)
    if t.executor == "cuda" and _wants_grad(x, weight):
        return _RMSNormFn.apply(x, weight, t, float(eps), float(scale_offset))
    return _rmsnorm_launch(x, weight, t, float(eps), float(scale_offset))


def _rmsnorm_launch(x, weight, t, eps, scale_offset):
    spec = _lm.rmsnorm_spec(int(x.shape[-1]))
    out = _tdp_launch(spec, t, x.T.contiguous(),
                      consts={"weight": weight, "eps": eps,
                              "scale_offset": scale_offset})
    return out.T


def gated_act(u, v=None, *, kind="swiglu", target=None, vvl=None,
              device=None):
    """Gated activation ``act(u) · v`` (or plain ``act(u)`` when ``v`` is
    ``None``) through ``tdp.launch`` — site = flattened element
    (:func:`repro_torch.kernels.lm.gated_act_spec`)."""
    dev = resolve_device(device)
    t = _lm_target(target, vvl, dev)
    u = torch.as_tensor(u, device=dev)
    if v is not None:
        v = torch.as_tensor(v, device=dev)
    if t.executor == "cuda" and _wants_grad(u, v):
        return _GatedActFn.apply(u, v, t, str(kind))
    return _gated_act_launch(u, v, t, str(kind))


def _gated_act_launch(u, v, t, kind):
    spec = _lm.gated_act_spec(kind, v is not None)
    args = (u.reshape(1, -1),)
    if v is not None:
        args += (v.reshape(1, -1),)
    return _tdp_launch(spec, t, *args).reshape(u.shape)


def mamba_scan(x, dt, b, c, a, d, *, target=None, vvl=None, device=None,
               chunk=128):
    """Selective state-space scan through ``tdp.launch`` — site = channel,
    time on the component axis (:func:`repro_torch.kernels.lm.mamba_scan_spec`),
    every batch row in one launch: ``x``/``dt``/``b``/``c`` go in as their
    ``(batch·L, ·)`` views, so contiguous operands are not copied.

    Shapes: ``x``/``dt`` ``(batch, L, d_inner)``, ``b``/``c``
    ``(batch, L, N)``, ``a`` ``(d_inner, N)``, ``d`` ``(d_inner,)``.
    Returns ``(y (batch, L, d_inner), h_final (batch, d_inner, N))``: y in
    x's dtype, h_final float32.  ``x``, ``dt``, ``b`` and ``c`` are float32
    or bfloat16 (one dtype), ``a`` and ``d`` float32, as the model passes
    them (the reference's site widens each to float32).  The
    ``"cuda"`` site function takes d_state 8 or 16 and raises
    ``ValueError`` for any other.  ``chunk``: the time chunk of the plain
    chunked scan (``models.ssm._chunked_scan``) that the backward pass
    recomputes under ``"cuda"``; ``h_final`` carries no gradient there."""
    dev = resolve_device(device)
    t = _lm_target(target, vvl, dev)
    x, dt, b, c, a, d = (torch.as_tensor(v, device=dev)
                         for v in (x, dt, b, c, a, d))
    if t.executor == "cuda" and _wants_grad(x, dt, b, c, a, d):
        return _MambaScanFn.apply(x, dt, b, c, a, d, t, int(chunk))
    return _mamba_scan_launch(x, dt, b, c, a, d, t)


def _mamba_scan_launch(x, dt, b, c, a, d, t):
    batch, length, d_inner = (int(s) for s in x.shape)
    nstate = int(a.shape[-1])
    spec = _lm.mamba_scan_spec(length, nstate, batch)
    rows = batch * length
    y, h = _tdp_launch(spec, t, x.reshape(rows, d_inner).contiguous(),
                       dt.reshape(rows, d_inner).contiguous(),
                       a.T.contiguous(), d.reshape(1, d_inner).contiguous(),
                       consts={"b": b.reshape(rows, nstate).contiguous(),
                               "c": c.reshape(rows, nstate).contiguous()})
    # h contiguous as (batch, d_inner, N): decode's elementwise updates keep
    # their operand's layout, so a transposed view would slow every step
    return (y.reshape(batch, length, d_inner),
            h.reshape(batch, nstate, d_inner).transpose(1, 2).contiguous())


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, target=None, device=None, impl="ref",
                    block_q=None, q_offset=0):
    """Attention of ``q (B, Hq, Sq, Dh)`` over ``k, v (B, Hkv, Sk, Dh)``:
    the CUDA kernel under ``"cuda"``; under ``"torch"`` the whole-score
    oracle (``impl="ref"``) or the memory-bounded one (``impl="chunked"``:
    ``block_q`` query rows at a time, default the target's tuning value or
    128, with a flash-style recompute backward).  Under ``"cuda"`` a
    gradient goes through :func:`repro_torch.kernels.ref._chunk_bwd` at
    ``block_q``.  ``q_offset`` (a shifted query block) serves
    sequence-parallel attention, which is not ported (ROADMAP A7.7)."""
    if impl not in ("ref", "chunked"):
        raise ValueError(f"flash_attention: impl must be 'ref' or 'chunked', "
                         f"got {impl!r}")
    if q_offset:
        raise NotImplementedError(
            "flash_attention: q_offset serves sequence-parallel attention, "
            "which is not ported yet (ROADMAP A7.7)")
    dev = resolve_device(device)
    t = _op_target(target, None, "cuda" if dev.type == "cuda" else "torch")
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    _fa.check_shapes(q, k, v)
    block_q = int(block_q if block_q is not None else t.tune("block_q", 128))
    if t.executor == "torch":
        if impl == "chunked":
            return _ref.attention_chunked_ref(
                q, k, v, causal=causal, window=window, softcap=softcap,
                scale=scale, block_q=block_q)
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    if t.executor == "cuda":
        if _wants_grad(q, k, v):
            scale = scale if scale is not None else q.shape[-1] ** -0.5
            return _FlashFn.apply(q, k, v, (bool(causal), int(window),
                                            float(softcap), float(scale),
                                            block_q, 0))
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    raise ValueError(f"flash_attention runs under the 'torch' or 'cuda' "
                     f"executor, got {t.executor!r}")


# ---------------------------------------------------------------------------
# gradients through the kernels
# ---------------------------------------------------------------------------

def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def _recompute_grads(plain, inputs, douts, needs):
    """Gradients of ``plain(*inputs)`` (the op's plain version, recomputed
    under autograd) against ``douts``, for the inputs ``needs`` marks;
    ``None`` for the others."""
    with torch.enable_grad():
        xs = [None if x is None else x.detach().requires_grad_(n)
              for x, n in zip(inputs, needs)]
        outs = plain(*xs)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        wrt = [x for x, n in zip(xs, needs) if n]
        gs = iter(torch.autograd.grad(outs, wrt, douts, allow_unused=True))
    return tuple(next(gs) if n else None for n in needs)


class _RMSNormFn(torch.autograd.Function):
    """Kernel 2's ``rmsnorm`` site.  Saves x and the weight (tensors the
    caller keeps anyway); the backward recomputes ``rmsnorm_ref``."""

    @staticmethod
    def forward(ctx, x, weight, t, eps, scale_offset):
        ctx.save_for_backward(x, weight)
        ctx.consts = (eps, scale_offset)
        return _rmsnorm_launch(x, weight, t, eps, scale_offset)

    @staticmethod
    def backward(ctx, dy):
        eps, offset = ctx.consts
        dx, dw = _recompute_grads(
            lambda x, w: _ref.rmsnorm_ref(x, w, eps=eps, scale_offset=offset),
            ctx.saved_tensors, (dy,), ctx.needs_input_grad[:2])
        return dx, dw, None, None, None


class _GatedActFn(torch.autograd.Function):
    """Kernel 2's ``gated`` (``v`` given) or ``act`` site.  Saves u and v
    (the GEMM outputs, alive until the down projection); the backward
    recomputes ``gated_act_ref``."""

    @staticmethod
    def forward(ctx, u, v, t, kind):
        ctx.save_for_backward(u, v)
        ctx.kind = kind
        return _gated_act_launch(u, v, t, kind)

    @staticmethod
    def backward(ctx, dy):
        du, dv = _recompute_grads(
            lambda u, v: _ref.gated_act_ref(u, v, kind=ctx.kind),
            ctx.saved_tensors, (dy,), ctx.needs_input_grad[:2])
        return du, dv, None, None


class _MambaScanFn(torch.autograd.Function):
    """Kernel 2's ``mamba`` site.  Saves the scan's six inputs; the
    backward recomputes the plain chunked scan (``models.ssm.
    _chunked_scan``, nothing of size L·d_inner·N live beyond a chunk's
    doubling levels) and takes its vector-Jacobian product.  ``h_final``
    is marked non-differentiable: training reads y only."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, t, chunk):
        ctx.save_for_backward(x, dt, b, c, a, d)
        ctx.chunk = chunk
        y, h = _mamba_scan_launch(x, dt, b, c, a, d, t)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        from repro_torch.models.ssm import _chunked_scan  # models import ops

        def plain(x, dt, b, c, a, d):
            return _chunked_scan(x, dt, b, c, a, d, chunk=ctx.chunk)[0]
        grads = _recompute_grads(plain, ctx.saved_tensors, (dy,),
                                 ctx.needs_input_grad[:6])
        return (*grads, None, None)


class _FlashFn(_ref._ChunkedAttention):
    """Kernel 4 with its log-sum-exp output as the forward of
    ``_ChunkedAttention``, whose backward it inherits: the flash-style
    recompute ``_chunk_bwd`` (one query block's probabilities at a time,
    from the saved log-sum-exp), rounding where the plain version's
    autograd rounds (``as_plain``: the softmax jacobian's diagonal term
    summed over the probabilities, not from the output, which bfloat16
    rounds; each query head's dk and dv rounded before a group's sum).
    Saves q, k, v, the output and the log-sum-exp (B, Hq, Sq).  ``cfg``:
    (causal, window, softcap, scale, block_q, q_offset)."""

    as_plain = True

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        causal, window, softcap, scale, _, _ = cfg
        return _FlashFn.keep(ctx, q, k, v, cfg, *_fa.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, return_lse=True))
