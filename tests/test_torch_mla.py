"""The port's Multi-head Latent Attention, multi-token prediction and
deepseek-v3-671b against the JAX package, on the CPU.

deepseek-v3's reduced config (``SMOKE``: one ``attn_dense`` and three
``attn_moe`` layers with a shared expert, MLA at q_lora 32, kv_lora 16,
rope 8, nope 16, v 16, one MTP module), the reference's weights (every
norm weight perturbed with seeded noise: the reference initialises them to
0, where a missing ``(1 + w)`` would pass) carried across by
``params.from_reference``; inputs made with numpy from fixed seeds.  The
reference's outputs are computed once per module (``ref`` fixture), its
loss and gradients in one jit.

Held: the configs field by field and ``count_params`` whole and at the
cuts a card runs (4 layers without MTP, 3 with it); ``mla_full``'s output
and latent cache and ``mla_decode`` over 3 steps at ``rtol=atol=2e-4``;
the absorbed decode against the expanded path's next token (the
reference's ``test_mla_decode_matches_prefill_continuation``); the prefill
logits and 3 greedy steps through ``build_serve_steps`` at 1e-3, tokens
equal, under the ``capacity`` and ``ragged`` MoE dispatches; ``loss_fn``'s
``ce``, ``mtp`` and ``loss`` at 1e-5 at ``mtp_weight`` 0.3 and 1.0 (and
without a loss mask, where the reference's MTP term scales with the
batch's rows); step
1's gradients at the chip script's ``TRAIN_TOL``; the decay mask of the
``mtp`` tree; the MLA caches' shapes and padding; the rope tables' width;
``attn_impl="chunked"`` against ``"ref"``; both launchers on the smoke
config.
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
from repro.models import mla as jmla
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models import params as tparams
from repro_torch.models.context import ExecContext
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.steps import TrainHParams

TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
#: step 1 against the reference, relative (``chip_smoke.py``'s)
TRAIN_TOL = {"loss": 1e-6, "grad_norm": 5e-5, "leaf_grad_norm": 8e-5}
ARCH = "deepseek_v3_671b"
B, S, N_GEN = 2, 12, 3
MTP_WEIGHTS = (0.3, 1.0)
#: (mtp_weight, with the batch's loss_mask) of the loss comparisons
LOSS_CASES = [(0.3, True), (1.0, True), (0.3, False)]


def _perturb(tree, rng):
    """Every norm weight plus 0.3·N(0, 1)."""
    if isinstance(tree, dict):
        return {k: (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                    if isinstance(v, np.ndarray) and "norm" in k
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng) for v in tree)
    return tree


def _jt(x):
    return jnp.asarray(x, jnp.int32)


@pytest.fixture(scope="module")
def ref():
    """The reference's SMOKE parameters (norms perturbed, numpy), a batch,
    its loss metrics at each of ``MTP_WEIGHTS`` and its gradients at 0.3
    (one jit, the weight a traced scalar), and its prefill logits and
    greedy steps under each MoE dispatch (jitted)."""
    cfg_j = JC.get_smoke(ARCH)
    p, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    np_params = _perturb(jax.tree.map(np.asarray, p),
                         np.random.default_rng(7))
    pj = jax.tree.map(jnp.asarray, np_params)
    r = np.random.default_rng(12)
    batch = {k: r.integers(0, cfg_j.vocab_size, (B, S))
             for k in ("tokens", "labels")}
    batch["loss_mask"] = (r.random((B, S)) < 0.8).astype(np.float32)
    jb = {"tokens": _jt(batch["tokens"]), "labels": _jt(batch["labels"]),
          "loss_mask": jnp.asarray(batch["loss_mask"])}
    vg = jax.jit(jax.value_and_grad(
        lambda prm, bt, w: jlm.loss_fn(prm, bt, cfg_j, JCtx(),
                                       mtp_weight=w), has_aux=True))
    losses, grads = {}, None
    for w in MTP_WEIGHTS:
        (_, metrics), g = vg(pj, jb, jnp.float32(w))
        losses[w, True] = {k: float(v) for k, v in metrics.items()}
        if grads is None:
            grads = jax.tree.map(np.asarray, g)
    unmasked = {k: v for k, v in jb.items() if k != "loss_mask"}
    losses[0.3, False] = {k: float(v) for k, v in jax.jit(
        lambda prm, bt: jlm.loss_fn(prm, bt, cfg_j, JCtx())[1])(
            pj, unmasked).items()}
    serving = {}
    for impl in ("capacity", "ragged"):
        ctx = JCtx(moe_impl=impl)
        pre = jax.jit(functools.partial(jlm.prefill, cfg=cfg_j, ctx=ctx))
        dec = jax.jit(functools.partial(jlm.decode_step, cfg=cfg_j, ctx=ctx))
        logits_j, caches, _ = pre(pj, {"tokens": jb["tokens"]})
        caches = jsteps._pad_caches(caches, cfg_j, S + N_GEN + 1)
        logits = [np.asarray(logits_j)]
        tokens = [np.asarray(jnp.argmax(logits_j[:, -1], -1))[:, None]]
        for i in range(N_GEN):
            lj, caches = dec(pj, _jt(tokens[-1]), caches,
                             jnp.asarray(S + i, jnp.int32))
            logits.append(np.asarray(lj))
            tokens.append(np.asarray(jnp.argmax(lj[:, -1], -1))[:, None])
        serving[impl] = (tokens, logits)
    return {"cfg_j": cfg_j, "np": np_params, "batch": batch,
            "losses": losses, "grads": grads, "serving": serving}


def _port(ref):
    cfg = TC.get_smoke(ARCH)
    return cfg, tparams.from_reference(ref["np"], cfg, device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the config and its counts
# ---------------------------------------------------------------------------

def test_config_copy_and_counts():
    """The configs are the reference's; ``count_params`` is the
    reference's whole and at the cuts a card runs (4 layers without the
    MTP block: 15 111 093 248; with it, an ``attn_moe`` block at that
    cut; 3 layers with it, an ``attn_dense`` one: 4 290 058 240); the
    smoke model's tensors (MTP included) hold that many elements and the
    latent norms' ``q_lora + kv_lora`` of each MLA block, which the
    reference's count leaves out."""
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module(ARCH), name)
        b = getattr(JC._module(ARCH), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params()
    full_t = TC.get_config("deepseek-v3-671b")
    full_j = JC.get_config(ARCH)
    assert full_t.num_params() == 682_636_331_008
    for n, mtp in ((4, 0), (4, 1), (3, 1)):
        ct = dataclasses.replace(TC.first_layers(full_t, n), mtp_depth=mtp)
        cj = dataclasses.replace(full_j, n_layers=n, mtp_depth=mtp,
                                 layer_program=full_j.layer_program[:n])
        assert ct.num_params() == cj.num_params()
    assert dataclasses.replace(TC.first_layers(full_t, 4),
                               mtp_depth=0).num_params() == 15_111_093_248
    assert TC.first_layers(full_t, 3).num_params() == 4_290_058_240
    cfg = TC.get_smoke(ARCH)
    p = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    norms = (cfg.n_layers + cfg.mtp_depth) * (cfg.mla.q_lora_rank
                                              + cfg.mla.kv_lora_rank)
    assert sum(t.numel() for t in tree_leaves(p)) == cfg.num_params() + norms
    assert len(p["mtp"]) == 1 and set(p["mtp"][0]) == {"proj", "block",
                                                       "norm"}
    assert "router" in p["mtp"][0]["block"]["mlp"]          # attn_moe
    ref0, _ = jparams.init_params(JC.get_smoke(ARCH), jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p["layers"][0]["attn"].items()} \
        == {k: tuple(v.shape[1:]) for k, v in
            ref0["groups"][0][0]["attn"].items()}


def test_from_reference_carries_mtp(ref):
    """Every layer's leaves unstacked from the reference's scan groups
    (one ``attn_dense``, then three ``attn_moe`` stacked) and the ``mtp``
    list carried leaf for leaf."""
    cfg, pt = _port(ref)
    assert set(pt) == {"embed", "lm_head", "layers", "final_norm", "mtp"}
    groups = ref["np"]["groups"]
    for i, (g, r) in enumerate([(0, 0), (1, 0), (1, 1), (1, 2)]):
        want = jax.tree.leaves(groups[g][0])
        got = tree_leaves(pt["layers"][i])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b[r])
    want = jax.tree.leaves(ref["np"]["mtp"])
    assert len(tree_leaves(pt["mtp"])) == len(want)
    for a, b in zip(tree_leaves(pt["mtp"]), want):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# MLA alone
# ---------------------------------------------------------------------------

def _mla_case(ref, s):
    cfg, pt = _port(ref)
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref["np"]["groups"][0][0]["attn"])
    x = np.random.default_rng(3).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    rope_j = jlm._rope_for({"tokens": jnp.zeros((B, s), jnp.int32)},
                           ref["cfg_j"], s)[0]
    rope_t = tlm._rope_for({"tokens": torch.zeros(B, s, dtype=torch.long)},
                           cfg, s)[0]
    return cfg, pt["layers"][0]["attn"], pj, x, rope_j, rope_t


@pytest.mark.parametrize("backend,impl", [("cuda", "ref"), ("torch", "ref"),
                                          ("torch", "chunked")])
def test_mla_full_matches_reference(ref, backend, impl):
    """The expanded path's output and its latent cache (c_kv, k_rope), on
    the kernels' route (their plain versions on the CPU) and on both
    plain oracles."""
    cfg, pt, pj, x, rope_j, rope_t = _mla_case(ref, 20)
    want, (wc, wk) = jmla.mla_full(pj, jnp.asarray(x), ref["cfg_j"], JCtx(),
                                   rope=rope_j)
    got, (gc, gk) = tmla.mla_full(pt, torch.from_numpy(x), cfg,
                                  ExecContext(backend=backend,
                                              attn_impl=impl), rope=rope_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)


def test_mla_decode_matches_reference(ref):
    """Three absorbed decode steps after a 9-token expanded prefill, the
    port writing its cache in place: each step's output and the cache."""
    cfg, pt, pj, x, _, _ = _mla_case(ref, 12)
    cj, ct = ref["cfg_j"], cfg
    s0 = 9
    pos = np.arange(12)[None].repeat(B, 0)
    tables_j = jlm._rope_for({"tokens": None}, cj, 12,
                             positions=jnp.asarray(pos, jnp.int32))[0]
    tables_t = tlm._rope_for({"tokens": None}, ct, 12,
                             positions=torch.from_numpy(pos))[0]
    _, (c0, k0) = tmla.mla_full(pt, torch.from_numpy(x[:, :s0]), ct,
                                ExecContext(),
                                rope=tuple(t[:, :s0] for t in tables_t))
    cache_t = {"c_kv": torch.zeros(B, 12, 16), "k_rope": torch.zeros(B, 12, 8)}
    cache_t["c_kv"][:, :s0], cache_t["k_rope"][:, :s0] = c0, k0
    cache_j = {k: jnp.asarray(v.numpy()) for k, v in cache_t.items()}
    for t in range(s0, 12):
        rj = tuple(a[:, t:t + 1] for a in tables_j)
        rt = tuple(a[:, t:t + 1] for a in tables_t)
        want, cache_j = jmla.mla_decode(pj, jnp.asarray(x[:, t:t + 1]), cj,
                                        JCtx(), cache_j, t, rope=rj)
        got, cache_t = tmla.mla_decode(pt, torch.from_numpy(x[:, t:t + 1]),
                                       ct, ExecContext(), cache_t, t, rope=rt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache_t[k].numpy(),
                                       np.asarray(cache_j[k]), **TOL)
    with pytest.raises(ValueError, match="pad the cache"):
        tmla.mla_decode(pt, torch.from_numpy(x[:, :1]), ct, ExecContext(),
                        cache_t, 12, rope=tuple(a[:, :1] for a in tables_t))


def test_mla_decode_matches_prefill_continuation(ref):
    """Absorbed-latent decode of token s after a prefill of s tokens ==
    the expanded full forward over s + 1 tokens at its last position (the
    reference's own test, at its tolerance)."""
    from repro_torch.models import layers
    cfg, pt = _port(ref)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 11)))
    ctx = ExecContext(backend="torch")
    h = tlm.forward_hidden(pt, {"tokens": toks}, cfg, ctx)
    want = layers.logits_from_hidden(pt, h[:, -1:], cfg)
    _, caches = tlm.prefill(pt, {"tokens": toks[:, :10]}, cfg, ctx)
    caches = tsteps._pad_caches(caches, cfg, 11)
    got, _ = tlm.decode_step(pt, toks[:, 10:], caches, 10, cfg, ctx)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# the model: serving, the loss, a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_greedy_serving_matches_reference(ref, impl):
    """Prefill 12 tokens, then 3 greedy steps through the serve steps on
    the kernels' route: tokens equal, every step's logits at 1e-3; the
    MTP module is never read."""
    cfg, pt = _port(ref)
    del pt["mtp"]
    want_tokens, want_logits = ref["serving"][impl]
    pre, dec = tsteps.build_serve_steps(cfg, ExecContext(moe_impl=impl),
                                        max_len=S + N_GEN + 1)
    toks = torch.from_numpy(ref["batch"]["tokens"])
    tok, caches, length, logits = pre(pt, {"tokens": toks})
    np.testing.assert_allclose(logits.numpy(), want_logits[0], **LOGIT_TOL)
    np.testing.assert_array_equal(tok.numpy(), want_tokens[0])
    for i in range(N_GEN):
        tok, caches, length, logits = dec(pt, tok, caches, length)
        np.testing.assert_allclose(logits.numpy(), want_logits[i + 1],
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tok.numpy(), want_tokens[i + 1])
    assert length == S + N_GEN


@pytest.mark.parametrize("weight,masked", LOSS_CASES)
def test_loss_with_mtp_matches_reference(ref, weight, masked):
    """``ce``, ``mtp`` (the wrapped tail and ``loss_mask`` masked) and
    ``loss = ce + weight · mtp``, on the kernels' route.  Without a loss
    mask the reference's MTP term divides the sum over every row by the
    live positions of one row (its mask is (1, S)), so it is B times a
    per-token mean: the port computes the same."""
    cfg, pt = _port(ref)
    batch = _tbatch(ref["batch"])
    if not masked:
        del batch["loss_mask"]
    loss, metrics = tlm.loss_fn(pt, batch, cfg, ExecContext(),
                                mtp_weight=weight)
    want = ref["losses"][weight, masked]
    assert set(metrics) == {"ce", "mtp", "loss"} == set(want)
    assert metrics["loss"] is loss
    for k in want:
        np.testing.assert_allclose(float(metrics[k]), want[k], **LOSS_TOL)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_train_step_one_matches_reference(ref):
    """Step 1 of ``build_train_step`` (one microbatch, ``.grad``
    accumulation, block remat, the ``"cuda"`` context, a fresh AdamW):
    its ``loss``, ``ce`` and ``mtp`` and the global gradient norm against
    the reference's, and each gradient leaf's norm (the MTP leaves
    included, none zero) at ``TRAIN_TOL``; ``TrainHParams.mtp_weight``
    weighs the MTP term (the reference's at 1.0); over two strided
    microbatches the metrics carry ``ce`` and ``mtp`` too."""
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg, pt = _port(ref)
    params = tparams.trainable(pt)
    seen = {}
    update = tsteps.adamw_update

    def keep_grads(p, grads, state, cfg_, **kw):
        seen["grads"] = grads
        return update(p, grads, state, cfg_, **kw)
    step = tsteps.build_train_step(cfg, ExecContext(remat="block"),
                                   AdamWConfig(), TrainHParams())
    tsteps.adamw_update = keep_grads
    try:
        _, _, metrics = step(params, adamw_init(params, AdamWConfig()),
                             _tbatch(ref["batch"]))
    finally:
        tsteps.adamw_update = update
    want = ref["losses"][0.3, True]
    for k in ("loss", "ce", "mtp"):
        assert _rel(float(metrics[k]), want[k]) <= TRAIN_TOL["loss"]
    wl = tree_leaves(tparams.from_reference(ref["grads"], cfg, device="cpu"))
    gl = tree_leaves(seen["grads"])
    assert len(gl) == len(wl) == len(tree_leaves(params))
    norm = lambda ls: float(torch.sqrt(sum((g * g).sum() for g in ls)))
    assert _rel(float(metrics["grad_norm"]), norm(wl)) <= \
        TRAIN_TOL["grad_norm"]
    for a, b in zip(gl, wl):
        assert _rel(float(a.norm()), float(b.norm())) <= \
            TRAIN_TOL["leaf_grad_norm"]
    assert all(float(g.norm()) > 0 for g in tree_leaves(seen["grads"]["mtp"]))
    # the step's mtp_weight, and two strided microbatches
    heavy = tsteps._metrics_and_grads(cfg, ExecContext(remat="block"),
                                      TrainHParams(mtp_weight=1.0))
    metrics1, _ = heavy(params, _tbatch(ref["batch"]))
    for k, v in ref["losses"][1.0, True].items():
        assert _rel(float(metrics1[k]), v) <= TRAIN_TOL["loss"]
    two = tsteps._metrics_and_grads(cfg, ExecContext(remat="block"),
                                    TrainHParams(grad_accum=2))
    metrics2, grads2 = two(params, _tbatch(ref["batch"]))
    assert set(metrics2) == {"ce", "mtp", "loss"}
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads2))


def test_weight_decay_mask_of_mtp(ref):
    """The reference's rule over its unstacked MTP tree: ``proj`` and the
    MTP block's matrices decayed; its ``norm``, ``norm1``, ``norm2``,
    ``q_norm`` and ``kv_norm`` not; every per-layer leaf decayed."""
    cfg, pt = _port(ref)
    mask = tparams.weight_decay_mask(pt)
    rule = tparams.from_reference(
        jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2), ref["np"]),
        cfg, device="cpu")
    assert tree_leaves(mask) == [bool(t.all()) for t in tree_leaves(rule)]
    m = mask["mtp"][0]
    assert m["proj"] and m["block"]["attn"]["w_uq"] and m["block"]["mlp"][
        "w_up"]
    assert not any((m["norm"], m["block"]["norm1"], m["block"]["norm2"],
                    m["block"]["attn"]["q_norm"],
                    m["block"]["attn"]["kv_norm"]))
    assert all(tree_leaves(mask["layers"]))


# ---------------------------------------------------------------------------
# caches, rope tables, the plain oracle, the launchers
# ---------------------------------------------------------------------------

def test_mla_caches_init_and_pad():
    """``init_cache`` gives every layer the latent cache of the
    reference's shapes; ``_pad_caches`` grows ``c_kv``/``k_rope`` along
    their sequence dimension, zero-filled."""
    cfg_j, cfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    want = jlm.init_cache(None, cfg_j, 3, 20, dtype=jnp.float32)
    got = tlm.init_cache(cfg, 3, 20, dtype=torch.float32, device="cpu")
    flat = [c for unit in want for c in unit]
    assert len(got) == cfg.n_layers
    for layer in got:
        assert set(layer) == {"c_kv", "k_rope"}
        assert tuple(layer["c_kv"].shape) == (3, 20, 16)
        assert tuple(layer["k_rope"].shape) == (3, 20, 8)
    assert {tuple(v.shape[1:]) for c in flat for v in c.values()} == {
        (3, 20, 16), (3, 20, 8)}
    full = tlm.init_cache(TC.get_config("deepseek-v3-671b"), 2, 7,
                          device="meta")
    assert len(full) == 61 and tuple(full[0]["c_kv"].shape) == (2, 7, 512)
    caches = [{"c_kv": torch.randn(2, 5, 16), "k_rope": torch.randn(2, 5, 8)}]
    padded = tsteps._pad_caches(caches, cfg, 9)
    assert tuple(padded[0]["c_kv"].shape) == (2, 9, 16)
    assert tuple(padded[0]["k_rope"].shape) == (2, 9, 8)
    assert torch.equal(padded[0]["c_kv"][:, :5], caches[0]["c_kv"])
    assert not padded[0]["k_rope"][:, 5:].any()


def test_rope_tables_at_the_rope_head_dim():
    """Under MLA the tables are at ``rope_head_dim`` (64 at full width),
    not ``attn.head_dim`` (128): half of it a table, as the reference's."""
    cfg = TC.get_config("deepseek-v3-671b")
    cos, sin = tlm._rope_for({"tokens": torch.zeros(1, 5, dtype=torch.long)},
                             cfg, 5)[0]
    assert tuple(cos.shape) == tuple(sin.shape) == (1, 5, 32)
    cj = JC.get_smoke(ARCH)
    want = jlm._rope_for({"tokens": jnp.zeros((1, 5), jnp.int32)}, cj, 5)[0]
    got = tlm._rope_for({"tokens": torch.zeros(1, 5, dtype=torch.long)},
                        TC.get_smoke(ARCH), 5)[0]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_attn_impl_chunked_matches_ref(ref):
    """The memory-bounded oracle (``attn_impl="chunked"``) gives the
    whole-score oracle's loss and gradients; an unknown impl raises."""
    cfg, _ = _port(ref)
    out = {}
    for impl in ("ref", "chunked"):
        params = tparams.trainable(tparams.from_reference(ref["np"], cfg,
                                                          device="cpu"))
        loss, _ = tlm.loss_fn(params, _tbatch(ref["batch"]), cfg,
                              ExecContext(backend="torch", attn_impl=impl))
        loss.backward()
        out[impl] = (loss.detach(), [p.grad for p in tree_leaves(params)])
    torch.testing.assert_close(out["chunked"][0], out["ref"][0], **LOSS_TOL)
    for a, b in zip(out["chunked"][1], out["ref"][1]):
        torch.testing.assert_close(a, b, **TOL)
    with pytest.raises(ValueError, match="attn_impl"):
        ExecContext(attn_impl="flash")


def test_launchers_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", "deepseek-v3-671b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "12", "--gen",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "deepseek-v3-smoke" in out and "req1:" in out
    trainer, hist = train.train(train.parse_args(
        ["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
         "--steps", "2", "--seq-len", "16", "--global-batch", "2",
         "--log-every", "1", "--ckpt-every", "0",
         "--ckpt-dir", str(tmp_path)]))
    assert [h["step"] for h in hist] == [1, 2]
    assert all({"ce", "mtp", "loss"} <= set(h) for h in hist)
    np.testing.assert_allclose(hist[0]["loss"], hist[0]["ce"]
                               + 0.3 * hist[0]["mtp"], rtol=1e-6)
    assert len(trainer.params["mtp"]) == 1
