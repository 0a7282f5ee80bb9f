"""bfloat16 parameters and caches (ROADMAP A7.1), the port against the JAX
package on the CPU.

The same numpy inputs and the reference's bfloat16 weights (``init_params(
..., jnp.bfloat16)``, carried across by ``params.from_reference``, which keeps
each leaf's dtype) go through both packages:

* ``init_params(dtype=torch.bfloat16)`` gives the reference's leaf dtypes,
  leaf by leaf, for every block type; ``from_reference`` keeps bfloat16
  values bit for bit; ``init_cache`` defaults to the reference's bfloat16
  (the SSM states float32);
* the plain versions of rmsnorm, every gated/act kind and attention
  (causal, window, softcap; Dh 128 and 256) on bfloat16 inputs against the
  reference's ops under ``"xla"`` and ``"pallas_interpret"``, within one
  bfloat16 step of the output (:func:`assert_within_bf16_step`);
* gemma3 and gemma2 (SMOKE) served in bfloat16: prefill logits, every
  cache leaf and four decode steps against the reference's bfloat16 run
  (bars below, from the measurement);
* one train step in bfloat16 with ``grad_accum=2`` against the
  reference's ``build_train_step``: the loss, each leaf's gradient norm
  and the updated bfloat16 parameters;
* the repairs: AdamW rounds a bfloat16 parameter once, as the reference
  does (bit for bit); accumulation sums each microbatch's gradient in
  float32; ``Trainer(param_dtype="bfloat16")`` builds, steps and restores
  its checkpoint bit for bit.

Both of the port's executors run where a kernel is on the path: ``"torch"``
(the plain versions) and ``"cuda"`` (on CPU tensors the wrappers run their
plain versions; their gradients are the ``torch.autograd.Function``s').
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw as jadamw
from repro.runtime import TrainHParams as JHParams
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.data import SyntheticConfig
from repro_torch.kernels import lm as tlm_kernels
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models.config import plan_layer_groups
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime import steps as tsteps

BF = torch.bfloat16
BACKENDS = ("torch", "cuda")
#: below this, outputs are held absolutely: float32's own error where a
#: result cancels (gelu's tail) is ~1e-7·|u|
BF16_ATOL = 1e-5
#: gemma3's bfloat16 prefill logits: the port's plain path rounds where the
#: reference rounds (measured 6.0e-8: float32 reassociation only)
EXACT_LOGITS = 1e-6
#: one bfloat16 rounding that lands on the other side (an exp or tanh a
#: float32 ulp apart between XLA and PyTorch: gemma2's attention softcap in
#: every prefill, a decode step's softmax now and then) moves the smoke
#: models' logits by up to 4.9e-3 (measured); the reference's own bfloat16
#: run is 1.6e-2 (gemma3) and 1.7e-2 (gemma2) from its float32 run on the
#: same weights
FLIP_LOGITS = 1e-2
#: gemma2's caches after its first layer (the first softcapped attention):
#: the flips above carried through the residual stream, relative to the
#: leaf's largest magnitude (measured up to 1.4e-2 at layer 3 of 4, about
#: three bfloat16 steps of it); gemma3's caches and gemma2's first layer's
#: are bit-equal
FLIP_CACHE = 2e-2
#: each leaf's gradient norm, relative: the port's backward rounds where
#: PyTorch's autograd rounds, not where XLA's cotangent casts do (measured
#: 6.9e-4 under "torch", 2.8e-3 under "cuda", whose attention backward is
#: the float32 recompute; the reference's own bfloat16 gradients are 2.6e-3
#: from its float32 ones)
LEAF_NORM_RTOL = 1e-2
#: the updated bfloat16 parameters: at most this share of them differ from
#: the reference's (measured 22 under "torch" and 79 under "cuda" of
#: 180 800).  At AdamW's first step every update is lr·g/(|g| + eps), so a
#: gradient element whose sign the bfloat16 noise flips moves its
#: parameter 2·lr the other way: each parameter is held within 2·lr and one
#: bfloat16 step of the reference's
PARAM_STEP_SHARE = 1e-3


def assert_within_bf16_step(got, want):
    """``got`` within one bfloat16 step of ``want`` (the spacing at
    ``want``, 2^-8 relative), or :data:`BF16_ATOL`: two float32 results a
    few ulps apart round to neighbouring bfloat16 values at most."""
    g = torch.as_tensor(np.asarray(got, np.float32)).float()
    w = torch.as_tensor(np.asarray(want, np.float32)).float()
    assert torch.isfinite(g).all()
    exp = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    bar = torch.exp2(exp - 7).clamp_min(BF16_ATOL)
    assert bool(((g - w).abs() <= bar).all()), float(((g - w).abs() / bar).max())


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _f32(x):
    return np.asarray(x, np.float32)


def _rand_bf16(seed, shape, scale=1.0):
    """Seeded numpy values, rounded to bfloat16 once: (jax, torch) twins."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    t = torch.from_numpy(x).to(BF)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _dtype_tree(tree):
    if isinstance(tree, dict):
        return {k: _dtype_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dtype_tree(v) for v in tree]
    return str(tree.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

ARCHS = ("gemma3_27b", "gemma2_2b", "falcon_mamba_7b", "zamba2_2p7b",
         "deepseek_v3_671b", "whisper_medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_dtypes_match_reference(arch):
    """Every leaf of ``init_params(dtype=torch.bfloat16)`` has the dtype of
    the reference's ``init_params(..., jnp.bfloat16)`` at the same place
    (``a_log``, ``dt_bias``, ``d_skip`` and the norms too); float32 stays
    the default."""
    cfg_j, cfg_t = JC.get_smoke(arch), TC.get_smoke(arch)
    pj, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.bfloat16)
    want = tparams._unstack(_np(pj), cfg_t,
                            lambda tree, r: _dtype_tree(tparams._to_torch(
                                tree, "cpu", index=r)))
    gen = torch.Generator().manual_seed(0)
    got = tparams.init_params(cfg_t, gen, "cpu", BF)
    assert _dtype_tree(got) == want
    assert set(tree_leaves(_dtype_tree(got))) == {"bfloat16"}
    default = tparams.init_params(cfg_t, torch.Generator().manual_seed(0),
                                  "cpu")
    assert {p.dtype for p in tree_leaves(default)} == {torch.float32}


def test_from_reference_keeps_bf16_bits():
    """A bfloat16 reference leaf becomes a bfloat16 tensor of the same
    values (through float32, exactly); ``dtype=`` casts them all."""
    cfg_j, cfg_t = JC.get_smoke("gemma3_27b"), TC.get_smoke("gemma3_27b")
    pj, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(3), jnp.bfloat16)
    pt = tparams.from_reference(_np(pj), cfg_t, device="cpu")
    wq = np.asarray(pj["groups"][0][0]["attn"]["wq"][0], np.float32)
    got = pt["layers"][0]["attn"]["wq"]
    assert got.dtype == BF
    np.testing.assert_array_equal(got.float().numpy(), wq)
    assert pt["embed"].dtype == BF
    np.testing.assert_array_equal(pt["embed"].float().numpy(),
                                  np.asarray(pj["embed"], np.float32))
    up = tparams.from_reference(_np(pj), cfg_t, device="cpu",
                                dtype=torch.float32)
    assert {p.dtype for p in tree_leaves(up)} == {torch.float32}
    np.testing.assert_array_equal(up["layers"][0]["attn"]["wq"].numpy(), wq)


@pytest.mark.parametrize("arch", ["gemma3_27b", "falcon_mamba_7b",
                                  "zamba2_2p7b", "deepseek_v3_671b",
                                  "whisper_medium"])
def test_init_cache_default_matches_reference(arch):
    """``init_cache``'s default dtypes are the reference's default:
    bfloat16, the SSM states float32; shapes per layer as the
    reference's groups hold them."""
    cfg_j, cfg_t = JC.get_smoke(arch), TC.get_smoke(arch)
    jc = jlm.init_cache(None, cfg_j, 2, 12)
    got = tlm.init_cache(cfg_t, 2, 12, device="cpu")
    offset = 0
    for g, (unit, k) in enumerate(plan_layer_groups(cfg_t.layer_program)):
        for r in range(k):
            for j in range(len(unit)):
                layer = got[offset + r * len(unit) + j]
                want = jax.tree.map(lambda x: x[r], jc[g][j])
                flat_w = jax.tree_util.tree_leaves_with_path(want)
                flat_g = jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                                 if t.dtype == torch.float32 else
                                 np.zeros(t.shape, jnp.bfloat16), layer))
                assert [(p, x.shape, x.dtype.name) for p, x in flat_w] == [
                    (p, x.shape, x.dtype.name) for p, x in flat_g]
        offset += k * len(unit)
    assert offset == len(got)


# ---------------------------------------------------------------------------
# the plain versions on bfloat16 inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jbackend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_rmsnorm_bf16_matches_reference(jbackend, backend):
    for t, d in ((37, 64), (5, 2304)):
        xj, xt = _rand_bf16(0, (t, d), 2.0)
        wj, wt = _rand_bf16(1, (d,), 0.5)
        want = jops.rmsnorm(xj, wj, scale_offset=1.0, backend=jbackend,
                            vvl=64)
        got = tops.rmsnorm(xt, wt, scale_offset=1.0, target=backend,
                           device="cpu")
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        assert_within_bf16_step(got.float(), _f32(want))


@pytest.mark.parametrize("jbackend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gated_act_bf16_matches_reference(jbackend, backend):
    for kind in tlm_kernels.GATED_KINDS:
        for gated in (True, False):
            uj, ut = _rand_bf16(2, (33, 96), 3.0)
            vj, vt = _rand_bf16(3, (33, 96)) if gated else (None, None)
            want = jops.gated_act(uj, vj, kind=kind, backend=jbackend)
            got = tops.gated_act(ut, vt, kind=kind, target=backend,
                                 device="cpu")
            assert got.dtype == BF
            assert_within_bf16_step(got.float(), _f32(want))


_ATTN_BF16 = {
    "causal_dh128": dict(shape=(2, 4, 2, 64, 64, 128), causal=True),
    "window_dh128": dict(shape=(1, 4, 2, 96, 96, 128), causal=True,
                         window=24),
    "softcap_window_dh256": dict(shape=(1, 4, 2, 64, 64, 256), causal=True,
                                 window=32, softcap=50.0),
    "noncausal_dh256": dict(shape=(1, 2, 1, 48, 80, 256), causal=False),
}


@pytest.mark.parametrize("jbackend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(_ATTN_BF16))
def test_attention_bf16_matches_reference(jbackend, backend, case):
    c = dict(_ATTN_BF16[case])
    b, hq, hkv, sq, sk, dh = c.pop("shape")
    (qj, qt), (kj, kt), (vj, vt) = (
        _rand_bf16(10 + i, (b, h, s, dh))
        for i, (h, s) in enumerate([(hq, sq), (hkv, sk), (hkv, sk)]))
    want = jops.flash_attention(qj, kj, vj, backend=jbackend, block_q=32,
                                block_k=32, **c)
    got = tops.flash_attention(qt, kt, vt, target=backend, device="cpu", **c)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_within_bf16_step(got.float(), _f32(want))


# ---------------------------------------------------------------------------
# serving in bfloat16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gemma3_27b", "gemma2_2b"])
def served(request):
    """The reference's bfloat16 prefill over 2 × 24 tokens, its caches and
    four greedy decode steps (its serve steps), on its bfloat16 weights."""
    arch = request.param
    cfg_j, cfg_t = JC.get_smoke(arch), TC.get_smoke(arch)
    pj, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.bfloat16)
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 24))
    pre, _ = jsteps.build_serve_steps(cfg_j, JCtx(), max_len=24 + 5)
    key = jax.random.PRNGKey(0)
    tok, caches, length, _ = pre(pj, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 key)
    logits, _, _ = jlm.prefill(pj, {"tokens": jnp.asarray(toks, jnp.int32)},
                               cfg_j, JCtx())
    steps, jc = [], caches
    for _ in range(4):
        lg, jc = jlm.decode_step(pj, tok, jc, length, cfg_j, JCtx())
        tok = jsteps.sample_logits(lg, key)
        steps.append((_f32(lg), np.asarray(tok)))
        length = length + 1
    return {"arch": arch, "cfg": cfg_t, "params": tparams.from_reference(
        _np(pj), cfg_t, device="cpu"), "tokens": toks,
        "prefill": (_f32(logits), _np(caches)), "steps": steps}


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_serving_matches_reference(served, backend):
    """Prefill logits (gemma3 at :data:`EXACT_LOGITS`, gemma2's softcapped
    attention at :data:`FLIP_LOGITS`), every cache leaf bfloat16 and equal
    to the reference's (laid out by its scan groups; gemma2's after its
    first layer at :data:`FLIP_CACHE`), then four decode steps' logits at
    :data:`FLIP_LOGITS` with the same greedy tokens."""
    cfg = served["cfg"]
    pre, dec = tsteps.build_serve_steps(cfg, ExecContext(backend=backend),
                                        max_len=24 + 5)
    tok, caches, length, logits = pre(served["params"], {
        "tokens": torch.from_numpy(served["tokens"])})
    want_logits, want_caches = served["prefill"]
    bar = EXACT_LOGITS if served["arch"] == "gemma3_27b" else FLIP_LOGITS
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=bar)
    offset = 0
    for g, (unit, k) in enumerate(plan_layer_groups(cfg.layer_program)):
        for r in range(k):
            for j in range(len(unit)):
                layer = caches[offset + r * len(unit) + j]
                exact = served["arch"] == "gemma3_27b" or (
                    offset + r * len(unit) + j == 0)
                for name in ("k", "v"):
                    assert layer[name].dtype == BF
                    got = layer[name].float().numpy()
                    want = np.asarray(want_caches[g][j][name][r], np.float32)
                    np.testing.assert_allclose(
                        got, want, rtol=0,
                        atol=0 if exact else FLIP_CACHE * np.abs(want).max())
        offset += k * len(unit)
    for want_lg, want_tok in served["steps"]:
        tok, caches, length, lg = dec(served["params"], tok, caches, length)
        np.testing.assert_allclose(lg.numpy(), want_lg, rtol=0,
                                   atol=FLIP_LOGITS)
        np.testing.assert_array_equal(tok.numpy(), want_tok)


def test_gemma2_bf16_prefill_is_exact_without_the_softcap():
    """gemma2's distance comes from the attention softcap's tanh (XLA's and
    PyTorch's differ by a float32 ulp, which flips bfloat16 roundings):
    without it the prefill is at :data:`EXACT_LOGITS`."""
    import dataclasses
    cfg_j, cfg_t = JC.get_smoke("gemma2_2b"), TC.get_smoke("gemma2_2b")
    cfg_j = dataclasses.replace(cfg_j, attn=dataclasses.replace(
        cfg_j.attn, softcap=0.0))
    cfg_t = dataclasses.replace(cfg_t, attn=dataclasses.replace(
        cfg_t.attn, softcap=0.0))
    pj, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.bfloat16)
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 24))
    want, _, _ = jlm.prefill(pj, {"tokens": jnp.asarray(toks, jnp.int32)},
                             cfg_j, JCtx())
    got, _ = tlm.prefill(tparams.from_reference(_np(pj), cfg_t, device="cpu"),
                         {"tokens": torch.from_numpy(toks)}, cfg_t,
                         ExecContext(backend="cuda"))
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0,
                               atol=EXACT_LOGITS)


# ---------------------------------------------------------------------------
# training in bfloat16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_ref():
    """gemma2 SMOKE, bfloat16 weights, 4 × 16 tokens in two microbatches:
    the reference's accumulated gradients and one train step from AdamW
    step 1 (a nonzero learning rate), each jitted once."""
    cfg_j = JC.get_smoke("gemma2_2b")
    pj, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.bfloat16)
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (4, 17))
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}
    hp = JHParams(grad_accum=2, warmup_steps=2, total_steps=10)
    ctx = JCtx(remat="block")
    loss, grads = jax.jit(jsteps._grads_of(cfg_j, ctx, hp))(pj, jb)
    opt = jadamw.adamw_init(pj, JAdamW())
    opt["step"] = jnp.asarray(1, jnp.int32)
    p2, _, m = jax.jit(jsteps.build_train_step(cfg_j, ctx, JAdamW(), hp))(
        pj, opt, jb)
    return {"params": _np(pj), "batch": nb, "loss": float(loss),
            "grads": _np(grads), "p2": _np(p2),
            "metrics": {k: float(v) for k, v in m.items()}}


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_train_step_matches_reference(step_ref, backend):
    """The loss at ``rtol=1e-5``, each leaf's gradient norm at
    :data:`LEAF_NORM_RTOL`, the gradients float32 (accumulated), and the
    updated parameters bfloat16, within one bfloat16 step of the
    reference's, at most :data:`PARAM_STEP_SHARE` of them a step apart."""
    cfg = TC.get_smoke("gemma2_2b")
    hp = tsteps.TrainHParams(grad_accum=2, warmup_steps=2, total_steps=10)
    ctx = ExecContext(backend=backend, remat="block")
    batch = {k: torch.from_numpy(v) for k, v in step_ref["batch"].items()}

    def params():
        return tparams.trainable(tparams.from_reference(
            step_ref["params"], cfg, device="cpu"))
    metrics, grads = tsteps._metrics_and_grads(cfg, ctx, hp)(params(), batch)
    np.testing.assert_allclose(float(metrics["loss"]), step_ref["loss"],
                               rtol=1e-5)
    want_g = tparams._unstack(step_ref["grads"], cfg, lambda tree, r:
                              tparams._to_torch(tree, "cpu", index=r,
                                                dtype=torch.float32))
    for got, want in zip(tree_leaves(grads), tree_leaves(want_g)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got.norm()), float(want.norm()),
                                   rtol=LEAF_NORM_RTOL)
    p = params()
    opt = adamw_init(p, AdamWConfig())
    opt["step"] = torch.tensor(1, dtype=torch.int32)
    p2, opt, m = tsteps.build_train_step(cfg, ctx, AdamWConfig(), hp)(
        p, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), step_ref["metrics"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), step_ref["metrics"]["lr"],
                               rtol=1e-6)
    want_p = tparams.from_reference(step_ref["p2"], cfg, device="cpu")
    lr = float(m["lr"])
    apart, total = 0, 0
    for got, want in zip(tree_leaves(p2), tree_leaves(want_p)):
        assert got.dtype == want.dtype == BF
        g, w = got.detach().float(), want.float()
        step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(
            2.0 ** -126))) - 7)
        assert bool(((g - w).abs() <= 2 * lr + step).all())
        apart += int((got.detach() != want).sum())
        total += got.numel()
    assert apart <= PARAM_STEP_SHARE * total, (apart, total)
    assert {t.dtype for t in tree_leaves(opt["m"])} == {torch.float32}


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr", [3e-4, 1e-3])
def test_adamw_bf16_update_rounds_once(lr):
    """2^20 bfloat16 weights ~ N(0, 0.02²) with float32 gradients: the
    port's bfloat16 update is its float32 update of the same values
    (``p.float() - lr·step``) rounded to bfloat16 once, bit for bit, as the
    reference's ``(p.f32 - lr·step).astype(bf16)`` is.  XLA's and
    PyTorch's float32 arithmetic differ in the last bit on 5-13 % of these
    updates, which a bfloat16 rounding hides but where one lies on a
    boundary: the bfloat16 results differ from the reference's only there,
    by one step, on at most 1e-5 of them (measured 3).  Rounding ``lr·step``
    to bfloat16 first, as the update did, moved 1.7 % of them at lr
    3e-4."""
    rng = np.random.default_rng(7)
    w = (0.02 * rng.standard_normal((1024, 1024))).astype(np.float32)
    g = rng.standard_normal((1024, 1024)).astype(np.float32)
    wt = torch.from_numpy(w).to(BF)
    cfg_j, cfg_t = JAdamW(lr=lr), AdamWConfig(lr=lr)

    def ref(p):
        return np.asarray(jax.jit(lambda p, gg: jadamw.adamw_update(
            p, gg, jadamw.adamw_init(p, cfg_j), cfg_j))(
                {"w": p}, {"w": jnp.asarray(g)})[0]["w"], np.float32)

    def port(p):
        params = {"w": p.clone()}
        adamw_update(params, {"w": torch.from_numpy(g)},
                     adamw_init(params, cfg_t), cfg_t)
        return params["w"]
    got, got32 = port(wt), port(wt.float())
    assert got.dtype == BF
    assert torch.equal(got, got32.to(BF))
    want = ref(jnp.asarray(wt.float().numpy()).astype(jnp.bfloat16))
    want32 = ref(jnp.asarray(wt.float().numpy()))
    apart = got.float().numpy() != want
    assert not (apart & (got32.numpy() == want32)).any()
    assert apart.sum() <= 1e-5 * apart.size, int(apart.sum())
    assert_within_bf16_step(got.float(), want)
    assert not torch.equal(got, wt)


def test_grad_accum_sums_bf16_microbatches_in_float32():
    """With ``grad_accum=2`` on bfloat16 leaves the gradient is the float32
    sum of the two microbatches' gradients, each taken alone (its
    ``.grad``, bfloat16) and added in float32, times 1/2 — not their sum
    rounded to bfloat16 in ``.grad``."""
    cfg = TC.get_smoke("gemma2_2b")
    params = tparams.trainable(tparams.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu", BF))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 13)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ctx = ExecContext(backend="torch")
    hp = tsteps.TrainHParams(grad_accum=2)
    _, grads = tsteps._metrics_and_grads(cfg, ctx, hp)(params, batch)
    mbs = tsteps._microbatch(batch, 2)
    each = []
    for j in range(2):
        for p in tree_leaves(params):
            p.grad = None
        loss, _ = tlm.loss_fn(params, {k: v[j] for k, v in mbs.items()},
                              cfg, ctx)
        loss.backward()
        each.append([p.grad.clone() for p in tree_leaves(params)])
    for p in tree_leaves(params):
        p.grad = None
    rounded = 0
    for got, g0, g1 in zip(tree_leaves(grads), *each):
        assert got.dtype == torch.float32 and g0.dtype == BF
        want = (g0.float() + g1.float()) * 0.5
        assert torch.equal(got, want)
        rounded += int(((g0 + g1).float() * 0.5 != want).sum())
    assert rounded > 0      # the bfloat16 sum would have differed


def test_trainer_bf16_builds_steps_and_restores(tmp_path):
    """``Trainer(param_dtype="bfloat16")``: bfloat16 parameters, float32
    moments, three steps with finite losses, and its checkpoint (raw
    bfloat16 bytes) restored bit for bit."""
    cfg = TC.get_smoke("gemma2_2b")
    data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, seed=1)
    hp = tsteps.TrainHParams(grad_accum=2, warmup_steps=1, total_steps=10)

    def make():
        return Trainer(cfg, None, data, AdamWConfig(), hp,
                       TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                                     log_every=1, param_dtype="bfloat16",
                                     log=lambda *_: None), device="cpu")
    tr = make()
    assert {p.dtype for p in tree_leaves(tr.params)} == {BF}
    assert {m.dtype for m in tree_leaves(tr.opt_state["m"])} == {torch.float32}
    tr.train_steps(3)
    assert all(np.isfinite(h["loss"]) for h in tr.metrics_history)
    assert {p.dtype for p in tree_leaves(tr.params)} == {BF}
    back = make()
    assert back.restore_latest() and back.step == 3
    for a, b in zip(tree_leaves(back.params), tree_leaves(tr.params)):
        assert a.dtype == BF and torch.equal(a, b)
    for a, b in zip(tree_leaves(back.opt_state["v"]),
                    tree_leaves(tr.opt_state["v"])):
        assert torch.equal(a, b)
