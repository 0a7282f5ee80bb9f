"""The port's whisper (encoder, cross-attention, learned positions) against
the JAX package, on the CPU.

whisper's reduced config (``SMOKE``: 2 ``enc`` and 3 ``xattn`` layers,
d_model 64, 4 heads of 16, 16 audio frames, a 128-row position table),
the reference's weights (every norm weight perturbed with seeded noise:
the reference initialises them to 0, where a missing ``(1 + w)`` would
pass) carried across by ``params.from_reference``; token ids and audio
frames made with numpy from fixed seeds.  The reference's outputs are
computed once per module (``ref`` fixture), each of its functions jitted
once.

Held: the configs and ``count_params`` (793 073 664 for whisper-medium);
``from_reference`` leaf for leaf, the encoder's included; the weight-decay
mask against the reference's rule; ``lm.encode``, an ``enc`` and an
``xattn`` block, the prefill's logits and every cache leaf at
``rtol=atol=2e-4``; decode against the reference's prefill over the
S + 1 (and S + 2) tokens at 1e-4, and the reference's own ``decode_step``
pinned where it differs (it gives every decoded token position 0's row:
ROADMAP §C); train step 1 (loss, global and per-leaf gradient norms at
the chip script's ``TRAIN_TOL``, the AdamW step at the reference's
accumulation bar); ``_pad_caches`` on the nested ``xattn`` cache; both
launchers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw as jadamw
from repro.runtime import TrainHParams as JHParams
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.steps import TrainHParams

TOL = dict(rtol=2e-4, atol=2e-4)
#: decode against the reference's prefill over the same tokens
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
#: step 1 against the reference, relative (``chip_smoke.py``'s)
TRAIN_TOL = {"loss": 1e-6, "grad_norm": 5e-5, "leaf_grad_norm": 8e-5}
#: the AdamW step's parameters: the reference's own accumulation bar
#: (``tests/test_runtime.py::test_grad_accum_equivalence``)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
ARCH = "whisper_medium"
B, S = 2, 10
#: the reference's decode_step lands this far or more from its own
#: prefill over the same tokens (0.224 on this input)
POSITION_ZERO_GAP = 1e-2
HP = dict(warmup_steps=2, total_steps=10)


def _perturb(tree, rng):
    """Every norm weight plus 0.3·N(0, 1)."""
    if isinstance(tree, dict):
        return {k: (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                    if isinstance(v, np.ndarray) and "norm" in k
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng) for v in tree)
    return tree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's SMOKE parameters (norms perturbed, numpy), a batch
    of S + 2 tokens with audio frames, and, each jitted once: its encoder
    output; its prefill over S, S + 1 and S + 2 tokens (logits, caches);
    its decode step after the S-token prefill; its loss gradients and one
    ``build_train_step`` step on the S-token batch."""
    cfg_j = JC.get_smoke(ARCH)
    p, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    np_params = _perturb(_np(p), np.random.default_rng(7))
    pj = jax.tree.map(jnp.asarray, np_params)
    r = np.random.default_rng(12)
    toks = r.integers(0, cfg_j.vocab_size, (B, S + 2))
    batch = {"tokens": toks[:, :S],
             "labels": r.integers(0, cfg_j.vocab_size, (B, S)),
             "audio_embed": r.standard_normal(
                 (B, cfg_j.encoder.n_frames, cfg_j.d_model)).astype(
                     np.float32)}

    def jb(nb):
        return {k: jnp.asarray(v) if v.dtype == np.float32
                else jnp.asarray(v, jnp.int32) for k, v in nb.items()}
    ctx = JCtx()
    enc = np.asarray(jax.jit(functools.partial(jlm.encode, cfg=cfg_j,
                                               ctx=ctx))(pj, jb(batch)))
    pre = jax.jit(functools.partial(jlm.prefill, cfg=cfg_j, ctx=ctx))
    prefills = {}
    for s in (S, S + 1, S + 2):
        logits, caches, _ = pre(pj, jb({"tokens": toks[:, :s],
                                        "audio_embed": batch["audio_embed"]}))
        prefills[s] = (np.asarray(logits), _np(caches))
    caches = jsteps._pad_caches(jax.tree.map(jnp.asarray, prefills[S][1]),
                                cfg_j, S + 2)
    dec_logits, _ = jax.jit(functools.partial(
        jlm.decode_step, cfg=cfg_j, ctx=ctx))(
            pj, jnp.asarray(toks[:, S:S + 1], jnp.int32), caches,
            jnp.asarray(S, jnp.int32))
    vg = jax.jit(jax.value_and_grad(
        lambda prm, bt: jlm.loss_fn(prm, bt, cfg_j, ctx), has_aux=True))
    (loss, _), grads = vg(pj, jb(batch))
    step = jax.jit(jsteps.build_train_step(cfg_j, ctx, JAdamW(),
                                           JHParams(**HP)))
    p2, _, metrics = step(pj, jadamw.adamw_init(pj, JAdamW()), jb(batch))
    return {"cfg_j": cfg_j, "np": np_params, "pj": pj, "batch": batch,
            "toks": toks, "enc": enc, "prefills": prefills,
            "decode": np.asarray(dec_logits), "loss": float(loss),
            "grads": _np(grads), "stepped": _np(p2),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _port(ref):
    cfg = TC.get_smoke(ARCH)
    return cfg, tparams.from_reference(ref["np"], cfg, device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _flat_caches(caches_j):
    """The reference's caches (one scan group of the 3 ``xattn`` layers,
    leaves stacked) as the port's per-layer list."""
    (c,), = caches_j
    n = c["xk"].shape[0]
    return [{"self": {k: c["self"][k][i] for k in ("k", "v")},
             "xk": c["xk"][i], "xv": c["xv"][i]} for i in range(n)]


# ---------------------------------------------------------------------------
# the config, the parameters
# ---------------------------------------------------------------------------

def test_config_copy_and_counts():
    """The configs are the reference's, registered under the module name
    and the alias; ``count_params`` is 793 073 664 for whisper-medium and
    the reference's on SMOKE, where the port's tensors hold that many
    elements."""
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module(ARCH), name)
        b = getattr(JC._module(ARCH), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params() == jparams.count_params(b)
    full = TC.get_config("whisper-medium")
    assert full is TC.get_config(ARCH)
    assert full.num_params() == tparams.count_params(full) == 793_073_664
    cfg = TC.get_smoke(ARCH)
    p = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in tree_leaves(p)) == cfg.num_params()
    assert set(p) == {"embed", "pos_embed", "layers", "final_norm",
                      "encoder"}
    assert tuple(p["pos_embed"].shape) == (cfg.max_position, cfg.d_model)
    assert set(p["encoder"]) == {"layers", "final_norm", "pos_embed"}
    assert len(p["encoder"]["layers"]) == cfg.encoder.n_layers
    assert tuple(p["encoder"]["pos_embed"].shape) == (cfg.encoder.n_frames,
                                                      cfg.d_model)
    assert set(p["layers"][0]) == {"norm1", "attn", "norm2", "xattn",
                                   "norm_x", "mlp"}
    assert set(p["layers"][0]["mlp"]) == {"w_up", "w_down"}   # not gated
    assert set(p["encoder"]["layers"][0]) == {"norm1", "attn", "norm2",
                                              "mlp"}


def test_from_reference_round_trips_every_leaf(ref):
    """Every leaf carried: the decoder's scan group unstacked layer by
    layer, the encoder's too, both position tables and both final norms;
    the tree's leaves are the reference's, none left over."""
    cfg, pt = _port(ref)
    rp = ref["np"]
    (dec,), = rp["groups"]
    (enc,), = rp["encoder"]["groups"]
    for i in range(cfg.n_layers):
        want = jax.tree.leaves(dec)
        got = tree_leaves(pt["layers"][i])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b[i])
    for i in range(cfg.encoder.n_layers):
        want = jax.tree.leaves(enc)
        got = tree_leaves(pt["encoder"]["layers"][i])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b[i])
    for got, want in ((pt["pos_embed"], rp["pos_embed"]),
                      (pt["encoder"]["pos_embed"], rp["encoder"]["pos_embed"]),
                      (pt["encoder"]["final_norm"],
                       rp["encoder"]["final_norm"]),
                      (pt["final_norm"], rp["final_norm"]),
                      (pt["embed"], rp["embed"])):
        np.testing.assert_array_equal(got.numpy(), want)
    assert sum(t.numel() for t in tree_leaves(pt)) == sum(
        a.size for a in jax.tree.leaves(rp))


def test_weight_decay_mask_matches_reference_rule(ref):
    """The reference decays each leaf of its stacked tree with two or more
    dimensions: every encoder and decoder layer's leaves (norms included)
    and both position tables, not the final norms."""
    cfg, pt = _port(ref)
    mask = tparams.weight_decay_mask(pt)
    rule = tparams.from_reference(
        jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2), ref["np"]),
        cfg, device="cpu")
    assert tree_leaves(mask) == [bool(t.all()) for t in tree_leaves(rule)]
    assert mask["pos_embed"] and mask["encoder"]["pos_embed"]
    assert not mask["encoder"]["final_norm"] and not mask["final_norm"]
    assert mask["encoder"]["layers"][1]["norm2"]
    assert mask["layers"][2]["norm_x"]


# ---------------------------------------------------------------------------
# the encoder, the blocks, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_encode_matches_reference(ref, backend):
    """``lm.encode``: frames plus the encoder's position table, the
    ``enc`` stack (non-causal), the encoder's final norm."""
    cfg, pt = _port(ref)
    got = tlm.encode(pt, _tbatch(ref["batch"]), cfg,
                     ExecContext(backend=backend))
    np.testing.assert_allclose(got.numpy(), ref["enc"], **TOL)
    with pytest.raises(ValueError, match="audio_embed"):
        tlm.encode(pt, {"tokens": torch.zeros(1, 2, dtype=torch.long)}, cfg,
                   ExecContext())


@pytest.mark.parametrize("btype", ["enc", "xattn"])
def test_block_matches_reference(ref, btype):
    """An ``enc`` block (its input 16 frames) and an ``xattn`` block
    (S tokens attending to 16 frames: Sq ≠ Sk) in full mode: the output
    and, for ``xattn``, its cache ``self.k``/``self.v``, ``xk``/``xv``."""
    cfg, pt = _port(ref)
    cj = ref["cfg_j"]
    rng = np.random.default_rng(5)
    f = cfg.encoder.n_frames
    x = rng.standard_normal((B, f if btype == "enc" else S,
                             cfg.d_model)).astype(np.float32)
    enc_out = rng.standard_normal((B, f, cfg.d_model)).astype(np.float32)
    if btype == "enc":
        bp_t = pt["encoder"]["layers"][1]
        bp_j = jax.tree.map(lambda a: jnp.asarray(a[1]),
                            ref["np"]["encoder"]["groups"][0][0])
    else:
        bp_t = pt["layers"][1]
        bp_j = jax.tree.map(lambda a: jnp.asarray(a[1]),
                            ref["np"]["groups"][0][0])
    want, wc = jblocks.apply_block(btype, bp_j, jnp.asarray(x), cfg=cj,
                                   ctx=JCtx(), enc_out=jnp.asarray(enc_out))
    got, gc = tblocks.apply_block(btype, bp_t, torch.from_numpy(x), cfg=cfg,
                                  ctx=ExecContext(),
                                  enc_out=torch.from_numpy(enc_out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if btype == "xattn":
        assert set(gc) == {"self", "xk", "xv"}
        for a, b in ((gc["self"]["k"], wc["self"]["k"]),
                     (gc["self"]["v"], wc["self"]["v"]),
                     (gc["xk"], wc["xk"]), (gc["xv"], wc["xv"])):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        with pytest.raises(ValueError, match="enc_out"):
            tblocks.apply_block(btype, bp_t, torch.from_numpy(x), cfg=cfg,
                                ctx=ExecContext())


def test_prefill_logits_and_caches_match_reference(ref):
    """``lm.prefill`` on S tokens and the frames: the last logits and
    every layer's ``self.k``/``self.v`` (B, H, S, dh) and ``xk``/``xv``
    (B, H, 16, dh)."""
    cfg, pt = _port(ref)
    logits, caches = tlm.prefill(pt, _tbatch({
        "tokens": ref["toks"][:, :S],
        "audio_embed": ref["batch"]["audio_embed"]}), cfg, ExecContext())
    want_logits, want_caches = ref["prefills"][S]
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    want = _flat_caches(want_caches)
    assert len(caches) == len(want) == cfg.n_layers
    for got, w in zip(caches, want):
        assert set(got) == {"self", "xk", "xv"}
        for a, b in ((got["self"]["k"], w["self"]["k"]),
                     (got["self"]["v"], w["self"]["v"]),
                     (got["xk"], w["xk"]), (got["xv"], w["xv"])):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), b, **TOL)


# ---------------------------------------------------------------------------
# decode and the position of the decoded token
# ---------------------------------------------------------------------------

def test_decode_matches_reference_prefill_over_more_tokens(ref):
    """The port's prefill of S tokens, ``_pad_caches`` and two decode
    steps (the tokens S and S + 1, each at its own position) against the
    reference's prefill over S + 1 and S + 2 tokens, its last logits, at
    1e-4; the cross caches are read, never written."""
    cfg, pt = _port(ref)
    toks = torch.from_numpy(ref["toks"])
    ctx = ExecContext()
    _, caches = tlm.prefill(pt, {"tokens": toks[:, :S], "audio_embed":
                                 torch.from_numpy(ref["batch"]["audio_embed"])},
                            cfg, ctx)
    caches = tsteps._pad_caches(caches, cfg, S + 2)
    xk = [c["xk"].clone() for c in caches]
    for t in (S, S + 1):
        got, caches = tlm.decode_step(pt, toks[:, t:t + 1], caches, t, cfg,
                                      ctx)
        np.testing.assert_allclose(got.numpy(), ref["prefills"][t + 1][0],
                                   **DECODE_TOL)
    assert all(torch.equal(a, c["xk"]) for a, c in zip(xk, caches))


def test_reference_decode_gives_position_zero(ref):
    """Pins ROADMAP §C: the reference's ``decode_step`` differs from its
    own prefill over the same S + 1 tokens by more than
    ``POSITION_ZERO_GAP``, and the port reproduces it (at 1e-4) only when
    every row of its position table is row 0."""
    cfg, pt = _port(ref)
    want = ref["prefills"][S + 1][0]
    assert float(np.abs(ref["decode"] - want).max()) > POSITION_ZERO_GAP
    toks = torch.from_numpy(ref["toks"])
    ctx = ExecContext()
    _, caches = tlm.prefill(pt, {"tokens": toks[:, :S], "audio_embed":
                                 torch.from_numpy(ref["batch"]["audio_embed"])},
                            cfg, ctx)
    caches = tsteps._pad_caches(caches, cfg, S + 1)
    row0 = dict(pt, pos_embed=pt["pos_embed"][:1].expand_as(pt["pos_embed"]))
    got, _ = tlm.decode_step(row0, toks[:, S:S + 1], caches, S, cfg, ctx)
    np.testing.assert_allclose(got.numpy(), ref["decode"], **DECODE_TOL)


def test_greedy_serve_steps_on_the_kernels_route(ref):
    """``build_serve_steps`` on the ``"cuda"`` context (the kernels'
    plain versions on CPU tensors): the prefill's logits are the
    reference's, each greedy decode step's are the reference's prefill
    over the tokens so far, at 1e-4."""
    cfg, pt = _port(ref)
    pre, dec = tsteps.build_serve_steps(cfg, ExecContext(), max_len=S + 2)
    batch = {"tokens": torch.from_numpy(ref["toks"][:, :S]),
             "audio_embed": torch.from_numpy(ref["batch"]["audio_embed"])}
    tok, caches, length, logits = pre(pt, batch)
    np.testing.assert_allclose(logits.numpy(), ref["prefills"][S][0], **TOL)
    seq = torch.cat([batch["tokens"], tok], 1)
    tok, caches, length, logits = dec(pt, tok, caches, length)
    assert length == S + 1
    cj = ref["cfg_j"]
    want, _, _ = jlm.prefill(ref["pj"], {
        "tokens": jnp.asarray(seq.numpy(), jnp.int32),
        "audio_embed": jnp.asarray(ref["batch"]["audio_embed"])}, cj, JCtx())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               **DECODE_TOL)


def test_pad_caches_grows_the_nested_self_cache():
    """On an ``xattn`` cache ``_pad_caches`` grows ``self.k``/``self.v``
    to ``max_len`` (zero-filled) and leaves ``xk``/``xv`` at the
    frames; ``init_cache`` builds the reference's shapes."""
    cfg = TC.get_smoke(ARCH)
    f = cfg.encoder.n_frames
    caches = [{"self": {"k": torch.randn(2, 4, 5, 16),
                        "v": torch.randn(2, 4, 5, 16)},
               "xk": torch.randn(2, 4, f, 16), "xv": torch.randn(2, 4, f, 16)}]
    padded = tsteps._pad_caches(caches, cfg, 9)
    assert tuple(padded[0]["self"]["k"].shape) == (2, 4, 9, 16)
    assert tuple(padded[0]["self"]["v"].shape) == (2, 4, 9, 16)
    assert torch.equal(padded[0]["self"]["k"][:, :, :5],
                       caches[0]["self"]["k"])
    assert not padded[0]["self"]["v"][:, :, 5:].any()
    assert padded[0]["xk"] is caches[0]["xk"]
    assert padded[0]["xv"] is caches[0]["xv"]
    got = tlm.init_cache(cfg, 3, 20, dtype=torch.float32, device="cpu")
    want = _flat_caches(jlm.init_cache(None, JC.get_smoke(ARCH), 3, 20,
                                       dtype=jnp.float32))
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert tuple(g["self"]["k"].shape) == tuple(w["self"]["k"].shape) \
            == (3, 4, 20, 16)
        assert tuple(g["xk"].shape) == tuple(w["xk"].shape) == (3, 4, f, 16)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_one_matches_reference(ref):
    """Step 1 of ``build_train_step`` (block remat, the ``"cuda"``
    context, a fresh AdamW) on a batch with audio frames: the loss, the
    global gradient norm and each leaf's gradient norm (every encoder
    leaf and both position tables among them, none zero) at ``TRAIN_TOL``
    of the reference's; the learning rate and the stepped parameters
    against the reference's ``build_train_step``."""
    cfg, pt = _port(ref)
    params = tparams.trainable(pt)
    seen = {}
    update = tsteps.adamw_update

    def keep_grads(p, grads, state, cfg_, **kw):
        seen["grads"] = grads
        return update(p, grads, state, cfg_, **kw)
    step = tsteps.build_train_step(cfg, ExecContext(remat="block"),
                                   AdamWConfig(), TrainHParams(**HP))
    tsteps.adamw_update = keep_grads
    try:
        p2, opt, metrics = step(params, adamw_init(params, AdamWConfig()),
                                _tbatch(ref["batch"]))
    finally:
        tsteps.adamw_update = update
    want = ref["metrics"]
    assert _rel(float(metrics["loss"]), ref["loss"]) <= TRAIN_TOL["loss"]
    assert _rel(float(metrics["loss"]), want["loss"]) <= TRAIN_TOL["loss"]
    assert _rel(float(metrics["grad_norm"]), want["grad_norm"]) <= \
        TRAIN_TOL["grad_norm"]
    np.testing.assert_allclose(float(metrics["lr"]), want["lr"], rtol=1e-6)
    wl = tree_leaves(tparams.from_reference(ref["grads"], cfg, device="cpu"))
    gl = tree_leaves(seen["grads"])
    assert len(gl) == len(wl) == len(tree_leaves(params))
    for a, b in zip(gl, wl):
        assert _rel(float(a.norm()), float(b.norm())) <= \
            TRAIN_TOL["leaf_grad_norm"]
    enc_grads = tree_leaves(seen["grads"]["encoder"])
    assert all(float(g.norm()) > 0 for g in enc_grads)
    assert float(seen["grads"]["pos_embed"][:S].norm()) > 0
    assert int(opt["step"]) == 1
    stepped = tparams.from_reference(ref["stepped"], cfg, device="cpu")
    for a, b in zip(tree_leaves(p2), tree_leaves(stepped)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   **PARAM_TOL)


def test_remat_gives_the_same_gradients(ref):
    """Layer remat with the encoder's output an argument of every
    checkpointed decoder layer: the gradients of ``remat="none"`` bit for
    bit, the encoder's included."""
    cfg, _ = _port(ref)
    out = []
    for remat in ("none", "block"):
        params = tparams.trainable(_port(ref)[1])
        loss, _ = tlm.loss_fn(params, _tbatch(ref["batch"]), cfg,
                              ExecContext(remat=remat))
        loss.backward()
        out.append([p.grad for p in tree_leaves(params)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "whisper-medium", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "12", "--gen",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "whisper-smoke" in out and "prefill 2x12 tokens" in out
    assert "req1:" in out


def test_serve_stub_inputs_draw_the_reference_frames():
    """``stub_inputs`` draws ``audio_embed`` as the reference's launcher
    does: after the prompt's token ids, from the same generator."""
    from repro_torch.launch.serve import stub_inputs
    cfg = TC.get_smoke(ARCH)
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (2, 5))
    got = stub_inputs(cfg, 2, 5, rng, "cpu")
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (2, 5))
    want = rng.normal(size=(2, cfg.encoder.n_frames, cfg.d_model))
    assert set(got) == {"audio_embed"}
    np.testing.assert_array_equal(got["audio_embed"].numpy(),
                                  want.astype(np.float32))


def test_train_launcher_raises_for_the_encoder(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="audio_embed"):
        train.train(train.parse_args(
            ["--arch", "whisper-medium", "--smoke", "--device", "cpu",
             "--steps", "1", "--ckpt-dir", str(tmp_path)]))
