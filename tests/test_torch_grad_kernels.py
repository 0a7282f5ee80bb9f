"""Gradients through the four LM kernels, on the CPU.

Under the ``"cuda"`` target each LM op runs its kernel inside a
``torch.autograd.Function`` when an input requires a gradient
(``kernels/ops.py``); on CPU tensors the forward is the plain version, so
the backward runs here.  Held:

* each ``Function``'s gradients against autograd through the op's plain
  version (``rmsnorm_ref``, ``gated_act_ref``, the chunked scan, and
  ``attention_ref``), at ``rtol=1e-4, atol=1e-5`` (the flash backward is
  the recompute ``_chunk_bwd``: other arithmetic, same math), the
  pointwise ones exactly;
* no op, under either target, returns an output without ``grad_fn`` for
  an input that requires a gradient; with grad mode off or no input
  requiring one, today's path runs;
* ``attention_chunked_ref`` (value, row log-sum-exp, and its backward)
  against the JAX package's ``attention_chunked_ref``, ``_chunk_fwd`` and
  ``jax.vjp`` on the same numpy inputs, at ``rtol=1e-4, atol=1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.models.ssm import _chunked_scan

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


def _grads(out, inputs, seed=99):
    g = torch.from_numpy(_rand(seed, tuple(out.shape)))
    return torch.autograd.grad(out, inputs, g)


# ---------------------------------------------------------------------------
# each Function against autograd through its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,offset", [(37, 64, 0.0), (16, 48, 1.0),
                                        (1, 8, 1.0)])
def test_rmsnorm_fn_grads(n, d, offset):
    x, w = _leaf(_rand(1, (n, d))), _leaf(_rand(2, (d,), 0.1))
    y = ops.rmsnorm(x, w, target="cuda", scale_offset=offset, device="cpu")
    assert type(y.grad_fn).__name__ == "_RMSNormFnBackward"
    got = _grads(y, (x, w))
    want = _grads(ref.rmsnorm_ref(x, w, scale_offset=offset), (x, w))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind,gated", [("geglu", True), ("swiglu", True),
                                        ("relu2", True), ("gelu", False),
                                        ("silu", False)])
def test_gated_act_fn_grads(kind, gated):
    u = _leaf(_rand(3, (9, 33)))
    v = _leaf(_rand(4, (9, 33))) if gated else None
    y = ops.gated_act(u, v, kind=kind, target="cuda", device="cpu")
    assert type(y.grad_fn).__name__ == "_GatedActFnBackward"
    inputs = (u, v) if gated else (u,)
    got = _grads(y, inputs)
    want = _grads(ref.gated_act_ref(u, v, kind=kind), inputs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _mamba_inputs(batch, length, di, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, di)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((batch, length, di))).astype(np.float32)
    b = rng.standard_normal((batch, length, n)).astype(np.float32)
    c = rng.standard_normal((batch, length, n)).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, n)).astype(np.float32) * 0.5)
    d = rng.standard_normal((di,)).astype(np.float32)
    return [_leaf(t) for t in (x, dt, b, c, a, d)]


@pytest.mark.parametrize("shape,chunk", [((2, 20, 16, 8), 8),
                                         ((1, 13, 12, 16), 4),
                                         ((3, 9, 8, 8), 128)])
def test_mamba_scan_fn_grads(shape, chunk):
    """All six inputs' gradients against the plain chunked scan's;
    ``h_final`` carries none."""
    args = _mamba_inputs(*shape, seed=5)
    y, h = ops.mamba_scan(*args, target="cuda", device="cpu", chunk=chunk)
    assert type(y.grad_fn).__name__ == "_MambaScanFnBackward"
    assert not h.requires_grad
    want_y, want_h = _chunked_scan(*args, chunk=chunk)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, want_h.detach(), rtol=1e-5, atol=1e-5)
    got = _grads(y, args)
    want = _grads(want_y, args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


#: (B, Hq, Hkv, Sq, Sk, Dh), options: GQA, MQA, windows, softcap, a custom
#: scale, a ragged key count, rows with no live key (non-causal window).
FLASH_CASES = {
    "gqa_causal": ((2, 4, 2, 19, 19, 16), dict(causal=True)),
    "mqa_window_softcap": ((1, 4, 1, 24, 24, 8),
                           dict(causal=True, window=5, softcap=5.0)),
    "noncausal_ragged": ((1, 2, 2, 11, 17, 16), dict(causal=False)),
    "dead_rows": ((1, 2, 2, 20, 10, 8), dict(causal=False, window=5)),
    "scale": ((1, 2, 1, 13, 13, 16), dict(causal=True, scale=0.07)),
}


def _qkv(case, seed=7):
    (b, hq, hkv, sq, sk, dh), kw = FLASH_CASES[case]
    q = _leaf(_rand(seed, (b, hq, sq, dh)))
    k = _leaf(_rand(seed + 1, (b, hkv, sk, dh)))
    v = _leaf(_rand(seed + 2, (b, hkv, sk, dh)))
    return q, k, v, kw


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("block_q", [4, 128])
def test_flash_fn_grads(case, block_q):
    """q, k, v gradients through ``_FlashFn`` (forward: the plain version
    here, with its log-sum-exp; backward: ``_chunk_bwd`` in query blocks
    of ``block_q``) against autograd through ``attention_ref``."""
    q, k, v, kw = _qkv(case)
    o = ops.flash_attention(q, k, v, target="cuda", device="cpu",
                            block_q=block_q, **kw)
    assert type(o.grad_fn).__name__ == "_FlashFnBackward"
    torch.testing.assert_close(o, ref.attention_ref(q, k, v, **kw),
                               rtol=0, atol=0)
    got = _grads(o, (q, k, v))
    want = _grads(ref.attention_ref(q, k, v, **kw), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_attention_ref_lse(case):
    """The plain version's log-sum-exp: ``logsumexp`` of the live logits,
    -1e30 for a row with none (the kernel stores the same)."""
    q, k, v, kw = _qkv(case)
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    torch.testing.assert_close(o, ref.attention_ref(q, k, v, **kw))
    out, lse2 = ref._chunk_fwd(q.detach(), k.detach(), v.detach(), (
        kw.get("causal", True), kw.get("window", 0), kw.get("softcap", 0.0),
        kw.get("scale") or q.shape[-1] ** -0.5, 8, 0))
    torch.testing.assert_close(lse.detach(), lse2, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# no path returns a detached output to a grad-requiring input
# ---------------------------------------------------------------------------

def _run_op(name, target, grad_input):
    """(output, inputs) of op ``name`` with input ``grad_input`` requiring
    a gradient (the rest plain tensors)."""
    if name == "rmsnorm":
        xs = [torch.from_numpy(_rand(1, (6, 16))),
              torch.from_numpy(_rand(2, (16,)))]
    elif name in ("gated", "act"):
        xs = [torch.from_numpy(_rand(3, (5, 16)))]
        if name == "gated":
            xs.append(torch.from_numpy(_rand(4, (5, 16))))
    elif name == "mamba":
        xs = [t.detach() for t in _mamba_inputs(1, 6, 8, 8, seed=2)]
    else:
        q, k, v, _ = _qkv("gqa_causal")
        xs = [q.detach(), k.detach(), v.detach()]
    xs[grad_input].requires_grad_()
    if name == "rmsnorm":
        out = ops.rmsnorm(*xs, target=target, device="cpu")
    elif name in ("gated", "act"):
        out = ops.gated_act(*xs, kind="geglu", target=target, device="cpu")
    elif name == "mamba":
        out = ops.mamba_scan(*xs, target=target, device="cpu", chunk=4)[0]
    else:
        out = ops.flash_attention(*xs, target=target, device="cpu")
    return out, xs


OP_INPUTS = [("rmsnorm", 0), ("rmsnorm", 1), ("gated", 0), ("gated", 1),
             ("act", 0), ("mamba", 0), ("mamba", 1), ("mamba", 2),
             ("mamba", 3), ("mamba", 4), ("mamba", 5), ("flash", 0),
             ("flash", 1), ("flash", 2)]


@pytest.mark.parametrize("target", ["cuda", "torch"])
@pytest.mark.parametrize("name,i", OP_INPUTS)
def test_no_detached_output_for_a_grad_input(name, i, target):
    out, xs = _run_op(name, target, i)
    assert out.grad_fn is not None and out.requires_grad
    (g,) = torch.autograd.grad(out.sum(), (xs[i],))
    assert g.shape == xs[i].shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("name", ["rmsnorm", "gated", "mamba", "flash"])
def test_no_function_without_grad(name):
    """Grad mode off: the kernel path as it was, no ``grad_fn``."""
    with torch.no_grad():
        out, _ = _run_op(name, "cuda", 0)
    assert out.grad_fn is None and not out.requires_grad


# ---------------------------------------------------------------------------
# the chunked oracle against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("block_q", [4, 512])
def test_attention_chunked_ref_matches_reference(case, block_q):
    q, k, v, kw = _qkv(case, seed=11)
    qn, kn, vn = (x.detach().numpy() for x in (q, k, v))
    jargs = tuple(jnp.asarray(x) for x in (qn, kn, vn))
    o = ref.attention_chunked_ref(q, k, v, block_q=block_q, **kw)
    oj, vjp = jax.vjp(lambda a, b, c: jref.attention_chunked_ref(
        a, b, c, block_q=block_q, **kw), *jargs)
    torch.testing.assert_close(o.detach(), torch.from_numpy(np.array(oj)),
                               **GRAD_TOL)
    cfg = (kw.get("causal", True), kw.get("window", 0),
           kw.get("softcap", 0.0), kw.get("scale") or qn.shape[-1] ** -0.5,
           block_q, 0)
    _, lse = ref._chunk_fwd(q.detach(), k.detach(), v.detach(), cfg)
    _, lse_j = jref._chunk_fwd(*jargs, cfg)
    torch.testing.assert_close(lse, torch.from_numpy(np.array(lse_j)),
                               **GRAD_TOL)
    dout = _rand(12, qn.shape)
    got = torch.autograd.grad(o, (q, k, v), torch.from_numpy(dout))
    want = vjp(jnp.asarray(dout))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, torch.from_numpy(np.array(b)),
                                   **GRAD_TOL)


def test_flash_impl_chunked_runs_and_q_offset_raises():
    q, k, v, kw = _qkv("gqa_causal")
    o = ops.flash_attention(q, k, v, target="torch", device="cpu",
                            impl="chunked", block_q=8, **kw)
    torch.testing.assert_close(
        o, ref.attention_chunked_ref(q, k, v, block_q=8, **kw))
    assert type(o.grad_fn).__name__ == "_ChunkedAttentionBackward"
    for target in ("torch", "cuda"):
        with pytest.raises(NotImplementedError, match="A7.7"):
            ops.flash_attention(q, k, v, target=target, device="cpu",
                                impl="chunked", q_offset=16)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, device="cpu", impl="blocked")
