"""The port's Mamba-2 SSD and zamba2 (the weight-tied shared block) against
the JAX package, on the CPU.

* ``_segsum``: its values, and a finite gradient through ``exp`` where the
  sums above the diagonal would overflow it, against ``jax.grad``;
* ``_ssd_chunked`` at L ∈ {1, 31, 32, 77} with chunk 32, one and two B/C
  groups (two tell head g·R + r of group g from a tiled order), with and without
  an initial state: the output and the final state;
* ``mamba2_mixer`` on the full path and on decode, and decode token by
  token continuing a chunked prefill's caches;
* zamba2's reduced config (``SMOKE``: 5 ``mamba2`` layers and one
  ``shared_attn``) with the JAX weights carried across by
  ``params.from_reference`` (the tied block once), ``init_cache``,
  ``count_params`` against the unique tensors, greedy serving (prefill + 8
  steps) against the reference's ``"xla"`` and ``"pallas_interpret"``
  contexts;
* training, the loss and every gradient of step 1 against
  ``jax.value_and_grad`` at ``TRAIN_TOL`` (the chip script's bar) and one
  AdamW step against the reference's, on SMOKE, on SMOKE at 12 layers (the
  tied block used twice: its gradient is the sum over both uses) and on a
  narrow SMOKE whose shared attention has head_dim 80 (kernel 4's new
  instantiation on the card);
* a checkpoint round trip keeps the tie; the launchers on the CPU.

Tolerance ``rtol=atol=2e-4`` unless stated.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.config import AttnConfig as JAttn
from repro.models.config import repeat_program as jrepeat
from repro.models.context import ExecContext as JCtx
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.config import AttnConfig, repeat_program
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.steps import TrainHParams

TOL = dict(rtol=2e-4, atol=2e-4)
#: step 1 against the reference, relative: the loss, the global gradient
#: norm and each leaf's gradient norm (``chip_smoke.py``'s ``TRAIN_TOL``)
TRAIN_TOL = {"loss": 1e-6, "grad_norm": 5e-5, "leaf_grad_norm": 8e-5}
#: each gradient leaf: the norm of its difference from the reference's,
#: relative to the reference's norm (the worst measured on the CPU, an
#: ``a_log`` leaf summed over every step of every head: 1.2e-4), and the
#: tied block's leaves (1.2e-5 measured)
GRAD_REL, SHARED_GRAD_REL = 5e-4, 5e-5
#: the parameters after one AdamW step
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = "zamba2_2p7b"


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------

def test_segsum_value_and_gradient():
    """Values as the reference's (-inf above the diagonal), and the
    gradient of Σ w·exp(segsum) finite and equal to JAX's with steps of
    about -40: a difference taken above the diagonal and exponentiated
    before the mask would be exp(+1000), and NaN in the backward pass."""
    a = -40.0 * np.abs(_rand(1, (2, 3, 32))) - 1.0
    w = _rand(2, (2, 3, 32, 32))
    got = tssm._segsum(torch.from_numpy(a))
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-3)
    at = torch.from_numpy(a).requires_grad_(True)
    (torch.exp(tssm._segsum(at)) * torch.from_numpy(w)).sum().backward()
    gj = jax.grad(lambda x: (jnp.exp(jssm._segsum(x)) * w).sum())(
        jnp.asarray(a))
    assert torch.isfinite(at.grad).all()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(gj), **TOL)


def _ssd_inputs(b, length, h, p, g, n, seed):
    r = np.random.default_rng(seed)
    xh = r.standard_normal((b, length, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, length, h)))).astype(
        np.float32)
    a_h = -np.linspace(1.0, 4.0, h).astype(np.float32)
    bm = r.standard_normal((b, length, g, n), dtype=np.float32)
    cm = r.standard_normal((b, length, g, n), dtype=np.float32)
    d = r.standard_normal((h, 1), dtype=np.float32)
    return xh, dt, a_h, bm, cm, d


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("length", [1, 31, 32, 77])
def test_ssd_chunked_matches_reference(length, groups, init):
    """y and the final state at chunk 32: L shorter than a chunk, one
    short of it, whole, and past two chunks (padded steps must neither
    decay nor inject); two groups over four heads."""
    args = _ssd_inputs(2, length, 4, 8, groups, 6, seed=length + 10 * groups)
    state = _rand(3, (2, 4, 8, 6)) if init else None
    want_y, want_s = jssm._ssd_chunked(
        *map(jnp.asarray, args), chunk=32,
        init_state=None if state is None else jnp.asarray(state))
    got_y, got_s = tssm._ssd_chunked(
        *map(torch.from_numpy, args), chunk=32,
        init_state=None if state is None else torch.from_numpy(state))
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def _perturb(tree, rng):
    """Every norm weight, bias and ``dt_bias`` leaf plus 0.3·N(0, 1): the
    reference initialises them to 0, where a missing one would pass."""
    if isinstance(tree, dict):
        return {k: (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                    if isinstance(v, np.ndarray)
                    and ("norm" in k or k.startswith(("conv_b", "dt_bias")))
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng) for v in tree)
    return tree


def _smoke(mod, attn_cls, repeat, n_layers, head_dim, groups):
    """zamba2's SMOKE config of the package ``mod`` at ``n_layers`` (whole
    5:1 periods), ``groups`` B/C groups and, with ``head_dim``, a 2-head
    shared attention of that head_dim."""
    cfg = mod.get_smoke(ARCH)
    kw = {"n_layers": n_layers,
          "layer_program": repeat(("mamba2",) * 5 + ("shared_attn",),
                                  n_layers),
          "ssm": dataclasses.replace(cfg.ssm, n_groups=groups)}
    if head_dim:
        kw["attn"] = attn_cls(2, 2, head_dim)
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(n_layers=6, head_dim=0, groups=1, seed=0):
    """Reference parameters (norms, biases and dt_bias perturbed) of
    :func:`_smoke`'s config; returns (cfg_j, cfg_t, numpy params)."""
    cfg_j = _smoke(JC, JAttn, jrepeat, n_layers, head_dim, groups)
    cfg_t = _smoke(TC, AttnConfig, repeat_program, n_layers, head_dim, groups)
    p, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(seed), jnp.float32)
    return cfg_j, cfg_t, _perturb(jax.tree.map(np.asarray, p),
                                  np.random.default_rng(seed + 7))


def _mixer(np_params, layer=0):
    """Layer ``layer``'s mixer (a ``mamba2`` one): (jax, torch) dicts."""
    m = np_params["groups"][0][0]["mixer"]
    return ({k: jnp.asarray(v[layer]) for k, v in m.items()},
            {k: torch.from_numpy(np.array(v[layer])) for k, v in m.items()})


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_mixer_full_and_decode(groups):
    """The full-sequence mixer (its output and its caches) and one decode
    step from random caches, against the reference's."""
    cfg_j, cfg_t, np_params = _ref_params(groups=groups)
    pj, pt = _mixer(np_params)
    x = _rand(4, (2, 45, cfg_t.d_model))
    want, wc = jssm.mamba2_mixer(pj, jnp.asarray(x), cfg_j, JCtx())
    got, gc = tssm.mamba2_mixer(pt, torch.from_numpy(x), cfg_t,
                                ExecContext(backend="torch"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "conv_bc", "ssm"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **TOL)
    cache = {k: _rand(5 + i, np.asarray(wc[k]).shape)
             for i, k in enumerate(("conv", "conv_bc", "ssm"))}
    x1 = x[:, :1]
    want, wc = jssm.mamba2_mixer(pj, jnp.asarray(x1), cfg_j, JCtx(),
                                 cache={k: jnp.asarray(v)
                                        for k, v in cache.items()})
    got, gc = tssm.mamba2_mixer(pt, torch.from_numpy(x1), cfg_t,
                                ExecContext(backend="torch"),
                                cache={k: torch.from_numpy(v)
                                       for k, v in cache.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "conv_bc", "ssm"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **TOL)


def test_mamba2_decode_continues_the_chunked_prefill():
    """A chunked prefill of 40 tokens (two chunks of 32, the second
    ragged), then 8 tokens one at a time from its caches: the outputs of
    the full 48-token pass, two groups."""
    _, cfg_t, np_params = _ref_params(groups=2)
    _, pt = _mixer(np_params)
    ctx = ExecContext(backend="torch")
    x = torch.from_numpy(_rand(8, (2, 48, cfg_t.d_model)))
    want, _ = tssm.mamba2_mixer(pt, x, cfg_t, ctx)
    out, cache = tssm.mamba2_mixer(pt, x[:, :40], cfg_t, ctx)
    outs = [out]
    for t in range(40, 48):
        out, cache = tssm.mamba2_mixer(pt, x[:, t:t + 1], cfg_t, ctx,
                                       cache=cache)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), want, **TOL)


# ---------------------------------------------------------------------------
# zamba2's reduced config
# ---------------------------------------------------------------------------

def test_config_copy_and_counts():
    """The configs are the reference's; the full config's count is
    1 981 756 080; the count equals the elements of the unique tensors
    that ``init_params`` builds (the tied block once)."""
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module(ARCH), name)
        b = getattr(JC._module(ARCH), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params()
    assert TC.get_config("zamba2-2.7b").num_params() == 1_981_756_080
    for n_layers in (6, 12):
        _, cfg_t, _ = _ref_params(n_layers=n_layers)
        p = tparams.init_params(cfg_t, torch.Generator().manual_seed(0),
                                "cpu")
        leaves = tree_leaves(p)
        assert len({id(t) for t in leaves}) == len(leaves)
        assert sum(t.numel() for t in leaves) == cfg_t.num_params()
        shared = [i for i, b in enumerate(cfg_t.layer_program)
                  if b == "shared_attn"]
        assert len(shared) == n_layers // 6
        assert all(p["layers"][i] == {} for i in shared)


def test_from_reference_carries_the_tie():
    """``shared_block`` once, equal to the reference's; the ``shared_attn``
    positions empty; every mamba2 layer's leaves unstacked; the init's
    distributions (a_log, d_skip, dt_bias, out_norm) as the reference's."""
    _, cfg_t, np_params = _ref_params(n_layers=12)
    pt = tparams.from_reference(np_params, cfg_t, device="cpu")
    assert set(pt) == {"embed", "shared_block", "layers", "final_norm"}
    jt = jax.tree.leaves(np_params["shared_block"])
    assert len(jt) == len(tree_leaves(pt["shared_block"]))
    for a, b in zip(tree_leaves(pt["shared_block"]), jt):
        np.testing.assert_array_equal(a.numpy(), b)
    g = np_params["groups"][0]
    for r in range(2):
        for j in range(5):
            for k, v in g[j]["mixer"].items():
                np.testing.assert_array_equal(
                    pt["layers"][6 * r + j]["mixer"][k].numpy(), v[r])
        assert pt["layers"][6 * r + 5] == {}
    init = tparams.init_params(cfg_t, torch.Generator().manual_seed(0),
                               "cpu")
    ref0, _ = jparams.init_params(_ref_params(n_layers=12)[0],
                                  jax.random.PRNGKey(0))
    mixer, ref_mixer = init["layers"][0]["mixer"], ref0["groups"][0][0][
        "mixer"]
    assert {k: tuple(v.shape) for k, v in mixer.items()} == {
        k: tuple(v.shape[1:]) for k, v in ref_mixer.items()}
    for k in ("a_log", "d_skip", "dt_bias", "out_norm", "conv_b",
              "conv_b_bc"):
        np.testing.assert_allclose(mixer[k].numpy(),
                                   np.asarray(ref_mixer[k][0]), rtol=1e-6)
    assert {k: tuple(v.shape) for k, v in tparams.init_params(
        cfg_t, torch.Generator(), "cpu")["shared_block"]["attn"].items()} \
        == {k: v.shape for k, v in ref0["shared_block"]["attn"].items()}


def test_init_cache_matches_reference():
    cfg_j, cfg_t = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    want = jlm.init_cache(None, cfg_j, 3, 20, dtype=jnp.float32)
    got = tlm.init_cache(cfg_t, 3, 20, dtype=torch.float32, device="cpu")
    assert len(got) == cfg_t.n_layers == 6
    for layer in range(5):
        assert set(got[layer]) == {"conv", "conv_bc", "ssm"}
        for k in got[layer]:
            assert tuple(got[layer][k].shape) == tuple(
                want[0][0][k].shape[1:])
            assert got[layer][k].dtype == torch.float32
    assert set(got[5]) == {"k", "v"}
    assert tuple(got[5]["k"].shape) == tuple(want[1][0]["k"].shape[1:])
    # the full config: nine (B, 32, S, 80) caches, one per shared position
    full = tlm.init_cache(TC.get_config("zamba2-2.7b"), 1, 4, device="meta")
    kv = [c for c in full if "k" in c]
    assert len(kv) == 9 and all(tuple(c["k"].shape) == (1, 32, 4, 80)
                                for c in kv)
    assert tuple(full[0]["ssm"].shape) == (1, 80, 64, 64)


def test_pad_and_ring_caches_leave_the_ssm_state():
    """The serve steps grow only the shared block's k/v to the decode
    budget; conv, conv_bc and ssm keep their shapes and tensors; the ring
    cut leaves zamba2's (global) caches as they are."""
    _, cfg_t, np_params = _ref_params()
    pt = tparams.from_reference(np_params, cfg_t, device="cpu")
    pre, _ = tsteps.build_serve_steps(cfg_t, ExecContext(backend="torch"),
                                      max_len=21, local_ring=True)
    toks = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (2, 6))
    _, caches, length, _ = pre(pt, {"tokens": torch.from_numpy(toks)})
    assert length == 6
    s = cfg_t.ssm
    for c in caches[:5]:
        assert tuple(c["conv"].shape) == (2, s.d_conv - 1, 128)
        assert tuple(c["conv_bc"].shape) == (2, s.d_conv - 1, 2 * s.d_state)
        assert tuple(c["ssm"].shape) == (2, 8, 16, 16)
    assert tuple(caches[5]["k"].shape) == (2, 4, 21, 16)
    padded = tsteps._pad_caches(caches, cfg_t, 30)
    assert padded[0]["conv_bc"] is caches[0]["conv_bc"]
    assert padded[0]["ssm"] is caches[0]["ssm"]
    assert tuple(padded[5]["v"].shape) == (2, 4, 30, 16)
    ring = tsteps._ring_caches(caches, cfg_t, 6)
    assert all(a is b for a, b in zip(ring, caches))


def _jtokens(toks):
    return jnp.asarray(toks, jnp.int32)


@functools.lru_cache(maxsize=None)
def _jax_greedy(jax_backend: str, b: int, s: int, n_gen: int):
    """The reference's prefill logits, then ``n_gen`` greedy steps' logits
    and tokens, jitted, on the SMOKE weights of ``_ref_params``."""
    cfg_j, _, np_params = _ref_params()
    params_j = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.default_rng(2).integers(0, cfg_j.vocab_size, (b, s))
    ctx = JCtx(backend=jax_backend)
    pre = jax.jit(functools.partial(jlm.prefill, cfg=cfg_j, ctx=ctx))
    dec = jax.jit(functools.partial(jlm.decode_step, cfg=cfg_j, ctx=ctx))
    logits_j, caches, _ = pre(params_j, {"tokens": _jtokens(toks)})
    caches = jsteps._pad_caches(caches, cfg_j, s + n_gen + 1)
    logits = [np.asarray(logits_j)]
    tokens = [np.asarray(jnp.argmax(logits_j[:, -1], -1))[:, None]]
    for i in range(n_gen):
        lj, caches = dec(params_j, _jtokens(tokens[-1]), caches,
                         jnp.asarray(s + i, jnp.int32))
        logits.append(np.asarray(lj))
        tokens.append(np.asarray(jnp.argmax(lj[:, -1], -1))[:, None])
    return toks, tokens, logits


@pytest.mark.parametrize("jax_backend,backend", [("xla", "torch"),
                                                  ("pallas_interpret", "cuda")])
def test_greedy_serving_matches_reference(jax_backend, backend):
    """Prefill 40 tokens (two SSD chunks, the second ragged), then 8
    greedy decode steps through the serve steps: identical tokens, the
    prefill's and every step's logits within the bar."""
    _, cfg_t, np_params = _ref_params()
    b, s, n_gen = 2, 40, 8
    toks, jtokens, jlogits = _jax_greedy(jax_backend, b, s, n_gen)
    pt = tparams.from_reference(np_params, cfg_t, device="cpu")
    pre, dec = tsteps.build_serve_steps(cfg_t, ExecContext(backend=backend),
                                        max_len=s + n_gen + 1)
    tok, caches, length, logits = pre(pt, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), jlogits[0], **TOL)
    np.testing.assert_array_equal(tok.numpy(), jtokens[0])
    for i in range(n_gen):
        tok, caches, length, logits = dec(pt, tok, caches, length)
        np.testing.assert_allclose(logits.numpy(), jlogits[i + 1], **TOL)
        np.testing.assert_array_equal(tok.numpy(), jtokens[i + 1])
    assert length == s + n_gen


# ---------------------------------------------------------------------------
# training: step 1 and one AdamW step against the reference
# ---------------------------------------------------------------------------

#: (layers, shared head_dim (0: SMOKE's 16), batch, tokens)
TRAIN_CASES = {"smoke": (6, 0, 2, 32), "two_uses": (12, 0, 2, 32),
               "dh80": (6, 80, 1, 64)}
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    """The reference's loss and gradients of one batch (``jax.
    value_and_grad``, jitted), and its parameters after one AdamW step at
    ``LR`` from a fresh optimiser state."""
    n_layers, head_dim, b, s = TRAIN_CASES[case]
    cfg_j, cfg_t, np_params = _ref_params(n_layers=n_layers,
                                          head_dim=head_dim)
    r = np.random.default_rng(12)
    nb = {k: r.integers(0, cfg_j.vocab_size, (b, s))
          for k in ("tokens", "labels")}
    params_j = jax.tree.map(jnp.asarray, np_params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jlm.loss_fn(p, bt, cfg_j, JCtx())[0]))(
        params_j, {k: _jtokens(v) for k, v in nb.items()})
    new, _, _ = jadamw_update(params_j, grads,
                              jadamw_init(params_j, JAdamW()), JAdamW(),
                              lr=LR)
    return (cfg_t, np_params, nb, float(loss),
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new))


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_one_matches_reference(case):
    """The train step's gradients (``runtime.steps``: one microbatch,
    ``.grad`` accumulation, block remat, the ``"cuda"`` context, on the CPU
    the kernels' plain versions): the loss, the global norm and each
    leaf's norm at ``TRAIN_TOL``, each leaf's difference at ``GRAD_REL``;
    the tied block's gradient is the reference's (the sum over its uses)
    at ``SHARED_GRAD_REL``; one AdamW step on those gradients moves every
    parameter, the tied block's once, as the reference's does."""
    cfg, np_params, nb, want_loss, grads_j, new_j = _ref_step(case)
    params = tparams.trainable(tparams.from_reference(np_params, cfg,
                                                      device="cpu"))
    grads_of = tsteps._grads_of(cfg, ExecContext(backend="cuda",
                                                 remat="block"),
                                TrainHParams())
    loss, grads = grads_of(params, {k: torch.from_numpy(v)
                                    for k, v in nb.items()})
    want = tparams.from_reference(grads_j, cfg, device="cpu")
    assert _rel(float(loss), want_loss) <= TRAIN_TOL["loss"]
    gl, wl = tree_leaves(grads), tree_leaves(want)
    assert len(gl) == len(wl) == len(tree_leaves(params))
    norm = lambda ls: float(torch.sqrt(sum((g * g).sum() for g in ls)))
    assert _rel(norm(gl), norm(wl)) <= TRAIN_TOL["grad_norm"]
    for a, b in zip(gl, wl):
        assert _rel(float(a.norm()), float(b.norm())) <= \
            TRAIN_TOL["leaf_grad_norm"]
        assert float((a - b).norm() / b.norm()) <= GRAD_REL
    for a, b in zip(tree_leaves(grads["shared_block"]),
                    tree_leaves(want["shared_block"])):
        assert float((a - b).norm() / b.norm()) <= SHARED_GRAD_REL
    # the update on the reference's gradients: step 1 of AdamW is about
    # sign(g), which a gradient of ~eps turns either way
    before = [p.detach().clone() for p in tree_leaves(params)]
    state = adamw_init(params, AdamWConfig())
    adamw_update(params, want, state, AdamWConfig(), lr=LR,
                 decay=tparams.weight_decay_mask(params))
    assert int(state["step"]) == 0
    after = tree_leaves(params)
    want_new = tree_leaves(tparams.from_reference(new_j, cfg, device="cpu"))
    for p0, p1, w in zip(before, after, want_new):
        assert not torch.equal(p0, p1)
        np.testing.assert_allclose(p1.detach().numpy(), w.numpy(),
                                   **PARAM_TOL)


@pytest.mark.parametrize("arch,n_layers", [("zamba2_2p7b", 12),
                                            ("gemma2_2b", 0),
                                            ("falcon_mamba_7b", 0)])
def test_weight_decay_mask_is_the_references(arch, n_layers):
    """The train step decays the leaves the reference's AdamW decays: its
    own leaves of two or more dimensions, which after its stacking are
    every per-layer leaf (norms, biases, ``a_log`` included) and, outside
    the layers, the matrices (the tied block's matrices, not its norms)."""
    if n_layers:
        cfg_j, cfg, np_params = _ref_params(n_layers=n_layers)
    else:
        cfg_j, cfg = JC.get_smoke(arch), TC.get_smoke(arch)
        p, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, p)
    params = tparams.from_reference(np_params, cfg, device="cpu")
    ref_rule = tparams.from_reference(
        jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2), np_params), cfg,
        device="cpu")
    mask = tparams.weight_decay_mask(params)
    want = [bool(t.all()) for t in tree_leaves(ref_rule)]
    assert tree_leaves(mask) == want
    assert all(tree_leaves(mask["layers"]))
    assert not mask["final_norm"]
    if "shared_block" in mask:
        assert mask["shared_block"]["attn"]["wq"]
        assert not mask["shared_block"]["norm1"]


def test_checkpoint_round_trip_keeps_the_tie(tmp_path):
    """A trainer's tree (parameters and AdamW moments) saved and restored:
    the tied block's tensors stored once (one manifest key each), the
    ``shared_attn`` positions empty, every tensor restored bit for bit, and
    the restored model's loss the saved one's."""
    import json
    _, cfg, np_params = _ref_params(n_layers=12)
    params = tparams.from_reference(np_params, cfg, device="cpu")
    opt = adamw_init(params, AdamWConfig())
    tree = {"params": params, "opt": opt}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, extra={"step": 1}, blocking=True)
    manifest = json.loads(next(tmp_path.glob("step_*/manifest.json"))
                          .read_text())
    keys = [e["key"] for e in manifest["leaves"]]
    n_shared = len(tree_leaves(params["shared_block"]))
    for root in ("params", "opt/m", "opt/v"):
        assert sum(k.startswith(f"{root}/shared_block/") for k in keys) \
            == n_shared
    assert len(keys) == len(set(keys)) == len(tree_leaves(tree))
    restored, _, step = mgr.restore_latest(tree, device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert torch.equal(a, b)
    rp = restored["params"]
    assert [rp["layers"][i] for i in (5, 11)] == [{}, {}]
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 16)))}
    batch["labels"] = batch["tokens"]
    ctx = ExecContext(backend="torch")
    assert torch.equal(tlm.loss_fn(rp, batch, cfg, ctx)[0],
                       tlm.loss_fn(params, batch, cfg, ctx)[0])


def test_launchers_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "zamba2-smoke" in out and "req1:" in out
    assert train.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "32", "--global-batch",
                       "2", "--log-every", "1", "--ckpt-every", "2",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "final loss" in capsys.readouterr().out
