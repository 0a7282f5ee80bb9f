"""The port's Mixture-of-Experts against the JAX package, on the CPU.

``models/moe.py`` function by function, then granite-moe-1b-a400m's
reduced ``SMOKE`` config whole, with the reference's weights (every norm
weight perturbed with seeded noise first, as in
``tests/test_torch_dense_archs.py``) and optimiser state carried across by
``params.from_reference`` / ``from_reference_opt_state``.  Inputs are made
with numpy from fixed seeds.

Held: the granite configs field by field and the capacity formula;
``_route`` (experts equal, weights and probabilities at ``rtol=1e-5``);
``_apply_experts_capacity`` at a capacity that drops rows, with invalid
rows, bit for bit where the arithmetic is the same (which rows drop is the
reference's: the sort is stable); ``moe_mlp`` under ``capacity`` at a
forced-drop ``capacity_factor`` of 0.5, ``ragged``, and ``a2a`` without a
mesh, and on the reference tests' shared-expert config
(``tests/test_models.py::TestEquivalences._moe_cfg``), at ``rtol=2e-4,
atol=2e-4``; ``grouped_matmul``'s forward and gradients against the
reference's custom VJP; the smoke config's prefill logits and greedy
decode (tokens equal, logits at 1e-3) against the reference's ``"xla"`` and
``"pallas_interpret"`` contexts; step 1 of the ``Trainer`` with dense and
8-bit moments (loss, gradient norm, every leaf's gradient, the updated
parameters); a dense-then-MoE program (``attn_dense``, then ``attn_moe``
with a shared expert) through the loss and its gradients under both
dispatches; both launchers on the smoke config.

Routes.  A token whose k-th and (k+1)-th router probabilities lie closer
than the two implementations' rounding can pick another expert.  Every
comparison records both sides' ``_route`` results (the reference's through
``jax.debug.callback``), and :func:`hold_routes` fails if a route differs
where the reference's margin is 1e-5 or more; a route that differs below
that is reported (a warning naming its margin) and its token or sequence
is left out of the output comparison.  No seed is chosen to avoid one.
"""
import contextlib
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import SyntheticConfig as JData
from repro.data import batch_for_step
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models.config import AttnConfig as JAttn
from repro.models.config import ModelConfig as JModel
from repro.models.config import MoEConfig as JMoE
from repro.models.context import ExecContext as JCtx
from repro.optim import AdamWConfig as JAdamW
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro.runtime import TrainHParams as JHParams
from repro_torch import configs as TC
from repro_torch.data import SyntheticConfig
from repro_torch.models import lm, moe
from repro_torch.models import params as tparams
from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig, TrainHParams
from repro_torch.runtime import steps as tsteps

TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
#: a route may differ between the two implementations only where the
#: reference's k-th and (k+1)-th router probabilities are closer than this
ROUTE_MARGIN = 1e-5
ARCH = "granite_moe_1b_a400m"
B, S, N_GEN = 2, 14, 6


# ---------------------------------------------------------------------------
# recording and holding routes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_routes():
    """Yields (port, reference): lists that get each ``_route`` call's
    experts (T, K) and probabilities (T, E) as numpy arrays, in call
    order, on both sides (the reference's also under ``jax.jit``)."""
    port, ref = [], []
    t_route, j_route = moe._route, jmoe._route

    def t_wrapped(x2, w, cfg_moe):
        out = t_route(x2, w, cfg_moe)
        port.append((out[1].detach().numpy(), out[2].detach().numpy()))
        return out

    def j_wrapped(x2, w, cfg_moe):
        out = j_route(x2, w, cfg_moe)
        jax.debug.callback(lambda e, p: ref.append((np.asarray(e),
                                                    np.asarray(p))),
                           out[1], out[2], ordered=True)
        return out
    moe._route, jmoe._route = t_wrapped, j_wrapped
    try:
        yield port, ref
    finally:
        moe._route, jmoe._route = t_route, j_route


def route_margins(probs, k):
    """The gap between each row's k-th and (k+1)-th probability."""
    s = -np.sort(-probs, axis=-1)
    return s[:, k - 1] - s[:, k] if probs.shape[-1] > k else np.full(
        probs.shape[0], np.inf)


def hold_routes(port, ref, k, rows_per_group=1):
    """Fail if a route differs where the reference's margin is at least
    ``ROUTE_MARGIN``; warn for each near tie that differs.  Rows come in
    groups of ``rows_per_group`` (a sequence's tokens); returns the mask of
    groups whose routes all agree."""
    assert len(port) == len(ref) > 0
    ok = None
    for i, ((pe, _), (re_, rp)) in enumerate(zip(port, ref)):
        differ = np.any(np.sort(pe, -1) != np.sort(re_, -1), axis=-1)
        margins = route_margins(rp, k)
        assert not np.any(differ & (margins >= ROUTE_MARGIN)), (
            f"route call {i}: routes differ at margins "
            f"{margins[differ].tolist()}")
        for r in np.nonzero(differ)[0]:
            warnings.warn(f"near tie: route call {i} row {r} differs at a "
                          f"margin of {margins[r]:.3g}")
        agree = ~differ.reshape(-1, rows_per_group).any(-1)
        ok = agree if ok is None else ok & agree
    return ok


# ---------------------------------------------------------------------------
# configs and inputs
# ---------------------------------------------------------------------------

def moe_cfg(cf=8.0, shared=1, program=("attn_moe", "attn_moe"), port=True):
    """The reference tests' shared-expert config
    (``TestEquivalences._moe_cfg``), for either package."""
    Model, Attn, MoE = ((ModelConfig, AttnConfig, MoEConfig) if port
                        else (JModel, JAttn, JMoE))
    return Model(name="m", d_model=64, n_layers=len(program), vocab_size=256,
                 d_ff=128, layer_program=program, attn=Attn(4, 2, 16),
                 moe=MoE(num_experts=8, top_k=2, d_expert=32,
                         num_shared=shared, capacity_factor=cf))


def _perturb_norms(tree, rng):
    """Every leaf whose key names a norm, plus 0.3·N(0, 1) noise."""
    if isinstance(tree, dict):
        return {k: (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                    if "norm" in k and isinstance(v, np.ndarray)
                    else _perturb_norms(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb_norms(v, rng) for v in tree)
    return tree


def ref_params(cfg_j, seed=0):
    p, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(seed), jnp.float32)
    return _perturb_norms(jax.tree.map(np.asarray, p),
                          np.random.default_rng(seed + 5))


def layer_mlp(np_params, layer=0):
    """One layer's MoE parameters: (reference pytree, port dict)."""
    j = jax.tree.map(lambda a: jnp.asarray(a[layer]),
                     np_params["groups"][0][0]["mlp"])
    t = jax.tree.map(lambda a: torch.from_numpy(np.array(a[layer])),
                     np_params["groups"][0][0]["mlp"])
    return j, t


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))}


def _jbatch(nb):
    return {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}


def _tbatch(nb):
    return {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in nb.items()}


# ---------------------------------------------------------------------------
# configs, the capacity formula, routing
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module(ARCH), name)
        b = getattr(JC._module(ARCH), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params()
    assert TC.get_config("granite-moe-1b-a400m") is TC.get_config(ARCH)
    # the whole model in float32 on one card: 1.33e9 parameters
    assert abs(TC.get_config(ARCH).num_params() - 1.334e9) < 1e7


@pytest.mark.parametrize("t,cf,want", [
    (8192, 0.0, 2560), (2048, 0.0, 640), (2, 0.0, 8), (1, 4.0, 8),
    (8192, 4.0, 8192), (37, 1.3, 13)])
def test_capacity_formula(t, cf, want):
    """``cap = min(t·k, max(ceil(t·k·cf/e), 8))`` on Python numbers; a
    factor of 0 runs at 1.25 (granite's 8192-token prefill: 2560 slots, its
    8 × 256 training microbatch pair: 640, decode: 8)."""
    mo = dataclasses.replace(TC.get_config(ARCH).moe, capacity_factor=cf)
    assert moe.capacity(t, mo) == want
    k, e = mo.top_k, mo.num_experts
    cfj = cf or 1.25
    assert want == min(t * k, max(int(-(-t * k * cfj // e)), 8))


def test_route_matches_reference():
    mo = TC.get_config(ARCH).moe
    # granite's router scale: N(0, 1/d) weights on unit-variance tokens
    x, w = _x((300, 64), 1), _x((64, mo.num_experts), 2) / 8.0
    jw, je, jp = jmoe._route(jnp.asarray(x), jnp.asarray(w), mo)
    tw, te, tp = moe._route(torch.from_numpy(x), torch.from_numpy(w), mo)
    assert te.dtype == torch.int32 and tuple(te.shape) == (300, mo.top_k)
    agree = hold_routes([(te.numpy(), tp.numpy())],
                        [(np.asarray(je), np.asarray(jp))], mo.top_k)
    np.testing.assert_array_equal(te.numpy()[agree], np.asarray(je)[agree])
    np.testing.assert_allclose(tw.numpy()[agree], np.asarray(jw)[agree],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the expert paths
# ---------------------------------------------------------------------------

def test_apply_experts_capacity_drops_the_reference_rows():
    """300 rows into 8 experts at 24 slots each, a fifth of them invalid:
    the rows past an expert's 24th valid one in row order return zeros,
    every other row its expert's FFN, as in the reference."""
    cfg = moe_cfg(shared=0)
    cfg_j = moe_cfg(shared=0, port=False)
    jp, tp = layer_mlp(ref_params(cfg_j))
    n, cap = 300, 24
    rng = np.random.default_rng(3)
    xs = _x((n, 64), 4)
    e_ids = rng.integers(0, 8, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    want = np.asarray(jax.jit(functools.partial(
        jmoe._apply_experts_capacity, cfg=cfg_j, ctx=JCtx(), cap=cap))(
            jnp.asarray(xs), jnp.asarray(e_ids), jnp.asarray(valid), jp))
    got = moe._apply_experts_capacity(
        torch.from_numpy(xs), torch.from_numpy(e_ids),
        torch.from_numpy(valid), tp, cfg, ExecContext(backend="torch"),
        cap).numpy()
    # the reference's own rule: per expert, its first `cap` valid rows
    kept = np.zeros(n, bool)
    for e in range(8):
        kept[np.nonzero(valid & (e_ids == e))[0][:cap]] = True
    assert 0 < (~kept & valid).sum()
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, ~kept)
    np.testing.assert_array_equal(np.abs(want).sum(-1) == 0, ~kept)
    np.testing.assert_allclose(got, want, **TOL)


def _moe_mlp_pair(cfg, cfg_j, impl, x, np_params, layer=0):
    """(port out, reference out, agree mask) of one layer's MoE MLP."""
    jp, tp = layer_mlp(np_params, layer)
    with recorded_routes() as (port_r, ref_r):
        fn = jmoe.moe_a2a if impl == "a2a" else jmoe.moe_mlp
        want = np.asarray(jax.jit(functools.partial(
            fn, cfg=cfg_j, ctx=JCtx(moe_impl=impl)))(jp, jnp.asarray(x)))
        tfn = moe.moe_a2a if impl == "a2a" else moe.moe_mlp
        got = tfn(tp, torch.from_numpy(x), cfg,
                  ExecContext(backend="cuda", moe_impl=impl)).numpy()
    agree = hold_routes(port_r, ref_r, cfg.moe.top_k)
    return got, want, agree.reshape(x.shape[:2])


@pytest.mark.parametrize("impl", ["capacity", "ragged", "a2a"])
def test_moe_mlp_matches_reference(impl):
    """granite's expert shapes cut down (8 experts of 32, top 2) at a
    capacity factor of 0.5: the capacity path drops choices (at least 128
    of the 256), the ragged path none; ``a2a`` without a mesh is
    ``moe_mlp``."""
    cfg = moe_cfg(cf=0.5, shared=0)
    cfg_j = moe_cfg(cf=0.5, shared=0, port=False)
    x = _x((2, 64, 64), 6)
    got, want, agree = _moe_mlp_pair(cfg, cfg_j, impl, x, ref_params(cfg_j))
    np.testing.assert_allclose(got[agree], want[agree], **TOL)
    if impl != "ragged":
        # the drops bite: the ragged (dropless) output differs
        dropless, _, _ = _moe_mlp_pair(cfg, cfg_j, "ragged", x,
                                       ref_params(cfg_j))
        assert np.abs(dropless - got).max() > 1e-2


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_shared_expert_moe_matches_reference(impl):
    cfg, cfg_j = moe_cfg(), moe_cfg(port=False)
    x = _x((2, 24, 64), 7)
    got, want, agree = _moe_mlp_pair(cfg, cfg_j, impl, x, ref_params(cfg_j),
                                     layer=1)
    np.testing.assert_allclose(got[agree], want[agree], **TOL)


def test_capacity_equals_ragged_when_generous():
    """The reference's ``test_capacity_equals_ragged`` on the port: with a
    capacity factor of E/K or more the packed path is dropless."""
    cfg = moe_cfg()
    params = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _tbatch(_np_batch(cfg, 2, 16, seed=8))
    l1 = lm.loss_fn(params, batch, cfg, ExecContext(moe_impl="capacity"))[0]
    l2 = lm.loss_fn(params, batch, cfg, ExecContext(moe_impl="ragged"))[0]
    np.testing.assert_allclose(l1.item(), l2.item(), rtol=1e-5)


@pytest.mark.parametrize("gs", [[6, 2, 10, 6], [6, 0, 9, 5]])
def test_grouped_matmul_and_its_gradient_match_reference(gs):
    """The reference test's shapes (E 4, T 24, D 8, F 6); the second
    case's groups cover 20 of the 24 rows (the rest are zero) and leave
    one expert empty.  Gradients against the reference's custom VJP."""
    xs, w = _x((24, 8), 9), _x((4, 8, 6), 10)
    dy = _x((24, 6), 11)
    gj = jnp.asarray(gs, jnp.int32)

    def jloss(a, b):
        return (jmoe.grouped_matmul(a, b, gj) * jnp.asarray(dy)).sum()
    want = np.asarray(jmoe.grouped_matmul(jnp.asarray(xs), jnp.asarray(w), gj))
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xs),
                                                jnp.asarray(w))
    tx = torch.from_numpy(xs).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = moe.grouped_matmul(tx, tw, torch.tensor(gs))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert not got[sum(gs):].any()
    (got * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# granite's smoke config whole: serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _granite():
    cfg_j = JC.get_smoke(ARCH)
    return cfg_j, TC.get_smoke(ARCH), ref_params(cfg_j)


@pytest.mark.parametrize("jax_backend,backend", [("xla", "torch"),
                                                  ("pallas_interpret", "cuda")])
def test_greedy_serving_matches_reference(jax_backend, backend):
    """Prefill 14 tokens, then 6 greedy decode steps: the prefill's and
    every step's logits at 1e-3, the tokens identical, on every sequence
    whose routes agree with the reference's in every layer so far."""
    from repro.runtime import steps as jsteps
    cfg_j, cfg_t, np_params = _granite()
    nb = _np_batch(cfg_t, B, S, seed=11)
    nb.pop("labels")
    params_j = jax.tree.map(jnp.asarray, np_params)
    params_t = tparams.from_reference(np_params, cfg_t, device="cpu")
    ctx = JCtx(backend=jax_backend)
    jpre = jax.jit(functools.partial(jlm.prefill, cfg=cfg_j, ctx=ctx))
    jdec = jax.jit(functools.partial(jlm.decode_step, cfg=cfg_j, ctx=ctx))
    pre, dec = tsteps.build_serve_steps(cfg_t, ExecContext(backend=backend),
                                        max_len=S + N_GEN + 1)
    k = cfg_t.moe.top_k
    with recorded_routes() as (port_r, ref_r):
        logits_j, caches_j, _ = jpre(params_j, _jbatch(nb))
        jax.block_until_ready(logits_j)
        caches_j = jsteps._pad_caches(caches_j, cfg_j, S + N_GEN + 1)
        tok, caches, length, logits = pre(params_t, _tbatch(nb))
        ok = hold_routes(port_r, ref_r, k, rows_per_group=S)
        tok_j = np.asarray(jnp.argmax(logits_j[:, -1], -1))[:, None]
        np.testing.assert_allclose(logits.numpy()[ok], np.asarray(logits_j)[ok],
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tok.numpy()[ok], tok_j[ok])
        for i in range(N_GEN):
            port_r.clear()
            ref_r.clear()
            logits_j, caches_j = jdec(params_j, jnp.asarray(tok.numpy(),
                                                            jnp.int32),
                                      caches_j, jnp.asarray(S + i, jnp.int32))
            jax.block_until_ready(logits_j)
            tok, caches, length, logits = dec(params_t, tok, caches, length)
            ok &= hold_routes(port_r, ref_r, k)
            tok_j = np.asarray(jnp.argmax(logits_j[:, -1], -1))[:, None]
            np.testing.assert_allclose(logits.numpy()[ok],
                                       np.asarray(logits_j)[ok], **LOGIT_TOL)
            np.testing.assert_array_equal(tok.numpy()[ok], tok_j[ok])
    assert length == S + N_GEN
    assert ok.any()


# ---------------------------------------------------------------------------
# training: the Trainer's first step, and a dense-then-MoE program
# ---------------------------------------------------------------------------

DATA = SyntheticConfig(vocab_size=512, seq_len=16, global_batch=4, seed=1)
JDATA = JData(vocab_size=512, seq_len=16, global_batch=4, seed=1)


@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    """The reference trainer on granite's smoke config (its own seeded
    initialisation), with dense and with 8-bit moments: its initial
    parameters and optimiser state, then one step (metrics, parameters);
    and the gradients of that step's batch (the same for both)."""
    cfg_j = JC.get_smoke(ARCH)
    batch = {k: jnp.asarray(v) for k, v in batch_for_step(JDATA, 0).items()}
    grad_fn = jax.jit(jax.grad(
        lambda p, b: jlm.loss_fn(p, b, cfg_j, JCtx())[0]))
    out, grads = {}, None
    for quant in (False, True):
        tc = JTrainerConfig(ckpt_dir=str(tmp_path_factory.mktemp("jref")),
                            ckpt_every=1000, log_every=1, log=lambda *_: None)
        tr = JTrainer(cfg_j, None, JDATA, JAdamW(quantize_moments=quant),
                      JHParams(warmup_steps=2, total_steps=100), tc)
        init = (jax.tree.map(np.asarray, tr.params),
                jax.tree.map(np.asarray, tr.opt_state))
        if grads is None:
            grads = jax.tree.map(np.asarray, grad_fn(tr.params, batch))
        tr.train_steps(1)
        out[quant] = (init, tr.metrics_history[0],
                      jax.tree.map(np.asarray, tr.params), grads)
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_trainer_first_step_matches_reference(ref_train, quant, tmp_path):
    """Step 1 from the reference's parameters and optimiser state: the
    loss, the gradient norm, every leaf's gradient (the worst leaf's
    relative norm below 1e-4) and the updated parameters."""
    (np_params, np_opt), hist, final, grads_j = ref_train[quant]
    cfg = TC.get_smoke(ARCH)
    tr = Trainer(cfg, None, DATA, AdamWConfig(quantize_moments=quant),
                 TrainHParams(warmup_steps=2, total_steps=100),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=0,
                               log_every=1, log=lambda *_: None),
                 device="cpu")
    tr.params = tparams.trainable(tparams.from_reference(np_params, cfg,
                                                         device="cpu"))
    tr.opt_state = tparams.from_reference_opt_state(np_opt, cfg, device="cpu")
    seen = {}
    update = tsteps.adamw_update

    def keep_grads(params, grads, state, cfg_, **kw):
        seen["grads"] = [g.clone() for g in tree_leaves(grads)]
        return update(params, grads, state, cfg_, **kw)
    tsteps.adamw_update = keep_grads
    try:
        tr.train_steps(1)
    finally:
        tsteps.adamw_update = update
    got = tr.metrics_history[0]
    np.testing.assert_allclose(got["loss"], hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], hist["grad_norm"], rtol=1e-4)
    want = tree_leaves(tparams.from_reference(grads_j, cfg, device="cpu"))
    assert len(want) == len(seen["grads"])
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(seen["grads"],
                                                           want)]
    assert max(rel) < 1e-4, f"worst leaf's gradient differs by {max(rel)}"
    for a, b in zip(seen["grads"], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    for a, b in zip(tree_leaves(tr.params),
                    tree_leaves(tparams.from_reference(final, cfg,
                                                       device="cpu"))):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **PARAM_TOL)


@functools.lru_cache(maxsize=None)
def _dense_then_moe_ref(impl):
    cfg_j = moe_cfg(program=("attn_dense", "attn_moe", "attn_moe"),
                    port=False)
    np_params = ref_params(cfg_j, seed=2)
    nb = _np_batch(cfg_j, 2, 16, seed=12)
    with recorded_routes() as (_, ref_r):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, b, cfg_j, JCtx(moe_impl=impl)),
            has_aux=True))(jax.tree.map(jnp.asarray, np_params), _jbatch(nb))
        jax.block_until_ready(loss)
    return np_params, nb, float(loss), jax.tree.map(np.asarray, grads), \
        list(ref_r)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_dense_then_moe_program_loss_and_grads(impl):
    """``attn_dense``, then two ``attn_moe`` layers with a shared expert:
    the loss at ``rtol=1e-5`` and every gradient (the dense layer's, the
    router's, the experts' and the shared expert's) at ``rtol=1e-4,
    atol=1e-5`` against ``jax.value_and_grad``."""
    np_params, nb, want, gj, ref_r = _dense_then_moe_ref(impl)
    cfg = moe_cfg(program=("attn_dense", "attn_moe", "attn_moe"))
    params = tparams.trainable(tparams.from_reference(np_params, cfg,
                                                      device="cpu"))
    assert "router" not in params["layers"][0]["mlp"]
    assert "shared" in params["layers"][1]["mlp"]
    with recorded_routes() as (port_r, _):
        loss, _ = lm.loss_fn(params, _tbatch(nb), cfg,
                             ExecContext(backend="cuda", moe_impl=impl,
                                         remat="block"))
    assert hold_routes(port_r, ref_r, cfg.moe.top_k).all()
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    loss.backward()
    grads = tparams.from_reference(gj, cfg, device="cpu")
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert p.grad is not None
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **GRAD_TOL)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_cli_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "12", "--gen",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "granite-moe-smoke" in out and "req1:" in out


def test_train_cli_smoke_on_cpu(tmp_path):
    from repro_torch.launch import train
    trainer, hist = train.train(train.parse_args([
        "--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu",
        "--steps", "3", "--seq-len", "16", "--global-batch", "4",
        "--grad-accum", "2", "--log-every", "1", "--ckpt-dir",
        str(tmp_path)]))
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert trainer.cfg.name == "granite-moe-smoke"


def test_bad_moe_impl_raises():
    with pytest.raises(ValueError, match="moe_impl"):
        ExecContext(moe_impl="dense")
    assert ExecContext().moe_impl == "capacity"
