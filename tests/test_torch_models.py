"""The port's LM serving path against the JAX package, on the CPU.

gemma2's reduced config (``SMOKE``: 4 layers alternating ``local`` (window
8) and ``attn``, GQA 4/2, head_dim 16, softcap 50, final softcap 30) with
the JAX weights carried across by ``params.from_reference``.  Prefill
logits and every decode step's logits are held to the reference's ``"xla"``
path at its own prefill bar, ``rtol=2e-4, atol=2e-4``
(``tests/test_models.py::test_prefill_decode_consistency``), and greedy
tokens must be identical.  Both executors of the port run: ``"torch"``
(the plain versions) and ``"cuda"`` (on CPU tensors the kernels' wrappers
run their plain versions).  Prompts of 12–16 tokens are longer than the
window, so the local mask bites.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models.config import plan_layer_groups
from repro_torch.models.context import ExecContext
from repro_torch.runtime import steps as tsteps

TOL = dict(rtol=2e-4, atol=2e-4)
JCTX = JCtx()


@pytest.fixture(scope="module")
def smoke():
    cfg_j = JC.get_smoke("gemma2_2b")
    cfg_t = TC.get_smoke("gemma2_2b")
    params_j, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0),
                                      jnp.float32)
    np_params = jax.tree.map(np.asarray, params_j)
    return cfg_j, cfg_t, params_j, tparams.from_reference(np_params, cfg_t,
                                                       device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _np(x):
    return np.asarray(x, np.float32)


def test_config_copy_matches_reference():
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module("gemma2_2b"), name)
        b = getattr(JC._module("gemma2_2b"), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params()
        assert plan_layer_groups(a.layer_program) == [(("local", "attn"),
                                                       a.n_layers // 2)]
    # the full-width count quoted for the chip run: ~2.61e9 float32 params
    assert abs(TC.get_config("gemma2-2b").num_params() - 2.614e9) < 5e6


def test_from_reference_unstacks_layers(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    assert len(params_t["layers"]) == cfg_t.n_layers
    g = params_j["groups"][0]
    for layer in range(cfg_t.n_layers):
        r, j = divmod(layer, 2)
        np.testing.assert_array_equal(
            params_t["layers"][layer]["attn"]["wq"].numpy(),
            np.asarray(g[j]["attn"]["wq"][r]))
        np.testing.assert_array_equal(
            params_t["layers"][layer]["mlp"]["w_gate"].numpy(),
            np.asarray(g[j]["mlp"]["w_gate"][r]))


def test_from_reference_without_a_device_is_the_card(monkeypatch):
    """``device=None`` is the card, as in ``lb.sim.from_reference``: with
    none present the weights are not quietly put on the CPU."""
    cfg_t = TC.get_smoke("gemma2_2b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.from_reference({}, cfg_t)


def test_init_params_shapes_and_scale():
    cfg = TC.get_smoke("gemma2_2b")
    p = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref, _ = jparams.init_params(JC.get_smoke("gemma2_2b"),
                                 jax.random.PRNGKey(0))
    flat_t = {k: v for k, v in _flatten(p["layers"][0])}
    flat_j = {k: v for k, v in _flatten(jax.tree.map(
        lambda t: np.asarray(t[0]), ref["groups"][0][0]))}
    assert {k: tuple(v.shape) for k, v in flat_t.items()} == \
        {k: tuple(v.shape) for k, v in flat_j.items()}
    # same distribution: std of wq ≈ 1/sqrt(d)
    assert abs(float(p["layers"][0]["attn"]["wq"].std()) * 8.0 - 1.0) < 0.05
    assert tuple(p["embed"].shape) == (cfg.padded_vocab, cfg.d_model)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_logits_match_jax(smoke, backend):
    cfg_j, cfg_t, params_j, params_t = smoke
    toks = _tokens(cfg_t, 2, 16, seed=1)
    want, _, _ = jlm.prefill(params_j, {"tokens": jnp.asarray(toks, jnp.int32)},
                             cfg_j, JCTX)
    got, caches = tlm.prefill(params_t, {"tokens": torch.from_numpy(toks)},
                              cfg_t, ExecContext(backend=backend))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert len(caches) == cfg_t.n_layers
    assert tuple(caches[0]["k"].shape) == (2, 2, 16, 16)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_greedy_decode_matches_jax(smoke, backend):
    """Prefill 12 tokens, then 8 greedy decode steps through both packages'
    serve steps: identical tokens, every step's logits within the bar."""
    cfg_j, cfg_t, params_j, params_t = smoke
    b, s, n_gen = 2, 12, 8
    toks = _tokens(cfg_t, b, s, seed=2)
    jpre, _ = jsteps.build_serve_steps(cfg_j, JCTX, max_len=s + n_gen + 1)
    key = jax.random.PRNGKey(0)
    jtok, jcaches, jlen, _ = jpre(params_j, {"tokens": jnp.asarray(
        toks, jnp.int32)}, key)
    ctx = ExecContext(backend=backend)
    tpre, tdec = tsteps.build_serve_steps(cfg_t, ctx, max_len=s + n_gen + 1)
    ttok, tcaches, tlen, tlogits = tpre(params_t,
                                        {"tokens": torch.from_numpy(toks)})
    assert tcaches[0]["k"].shape[2] == s + n_gen + 1
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tuple(tlogits.shape) == (b, 1, cfg_t.padded_vocab)
    for _ in range(n_gen):
        jlogits, jcaches = jlm.decode_step(params_j, jtok, jcaches, jlen,
                                           cfg_j, JCTX)
        ttok, tcaches, tlen, tlogits = tdec(params_t, ttok, tcaches, tlen)
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **TOL)
        jtok = jsteps.sample_logits(jlogits, key)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlen = jlen + 1
    assert tlen == s + n_gen


def test_sliding_window_decode_past_window(smoke):
    """Decode past the window (prompt 14, window 8): the port's decode
    logits match the reference's full forward over the longer prompt, as
    ``tests/test_models.py::test_sliding_window_decode_matches_full``."""
    cfg_j, cfg_t, params_j, params_t = smoke
    b, s = 1, 14
    toks = _tokens(cfg_t, b, s + 3, seed=5)
    ctx = ExecContext(backend="cuda")
    _, caches = tlm.prefill(params_t, {"tokens": torch.from_numpy(toks[:, :s])},
                            cfg_t, ctx)
    caches = tsteps._pad_caches(caches, cfg_t, s + 3)
    for i in range(3):
        got, caches = tlm.decode_step(params_t, torch.from_numpy(
            toks[:, s + i:s + i + 1]), caches, s + i, cfg_t, ctx)
        h, _ = jlm.forward_hidden(params_j, {"tokens": jnp.asarray(
            toks[:, :s + i + 1], jnp.int32)}, cfg_j, JCTX)
        from repro.models import layers as jlayers
        want = jlayers.logits_from_hidden(params_j, h[:, -1:], cfg_j)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_ring_cache_decode_matches_jax(smoke):
    """Window-sized ring caches for the local layers, decoding from empty
    for 12 steps (past the window of 8): each step's logits match the
    reference's ring-buffer decode, and the port's full-length cache."""
    cfg_j, cfg_t, params_j, params_t = smoke
    b, n = 2, 12
    toks = _tokens(cfg_t, b, n, seed=7)
    jc = jlm.init_cache(None, cfg_j, b, n, dtype=jnp.float32, local_ring=True)
    ring = tlm.init_cache(cfg_t, b, n, dtype=torch.float32, device="cpu",
                          local_ring=True)
    full = tlm.init_cache(cfg_t, b, n, dtype=torch.float32, device="cpu")
    assert ring[0]["k"].shape[2] == cfg_t.attn.window
    assert ring[1]["k"].shape[2] == n
    ctx = ExecContext(backend="cuda")
    for i in range(n):
        tok = toks[:, i:i + 1]
        want, jc = jlm.decode_step(params_j, jnp.asarray(tok, jnp.int32), jc,
                                   i, cfg_j, JCTX)
        got, ring = tlm.decode_step(params_t, torch.from_numpy(tok), ring, i,
                                    cfg_t, ctx)
        got_full, full = tlm.decode_step(params_t, torch.from_numpy(tok),
                                         full, i, cfg_t, ctx)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        np.testing.assert_allclose(got_full.numpy(), got.numpy(), **TOL)


def test_sample_logits_modes():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[[0.0, 3.0, 1.0, 2.9]]]).repeat(3, 1, 1)
    assert tsteps.sample_logits(logits).tolist() == [[1]] * 3
    draws = {int(tsteps.sample_logits(logits, g, temperature=1.0,
                                      top_k=2)[0, 0]) for _ in range(50)}
    assert draws == {1, 3}


def test_serve_cli_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x12 tokens" in out and "req1:" in out


def test_unported_blocks_and_features_raise():
    """Every block type of the registry runs (whisper's ``enc`` and
    ``xattn`` and learned positions since their slice); what still
    raises: a name that is no block type, an ``xattn`` block outside
    decode without the encoder's output, an arch the registry lacks, an
    executor the context lacks."""
    import dataclasses
    from repro_torch.models import blocks
    cfg = TC.get_smoke("gemma2_2b")
    with pytest.raises(NotImplementedError, match="unknown block type"):
        blocks.apply_block("conv", {}, torch.zeros(1, 2, cfg.d_model),
                           cfg=cfg, ctx=ExecContext())
    hybrid = dataclasses.replace(cfg, layer_program=("attn", "xattn") * 2)
    params = tparams.init_params(hybrid, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="enc_out"):
        tlm.prefill(params, {"tokens": torch.zeros(1, 2, dtype=torch.long)},
                    hybrid, ExecContext())
    with pytest.raises(KeyError, match="not yet ported"):
        TC.get_config("whisper-large")
    with pytest.raises(ValueError, match="backend"):
        ExecContext(backend="xla")
