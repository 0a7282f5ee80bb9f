"""The port's dense architectures against the JAX package, on the CPU.

gemma3-27b (5:1 local/global, a local RoPE theta, qk-norm), qwen2-vl-2b
(M-RoPE, the vision stub), phi3-medium-14b (GQA 40/10, untied head) and
nemotron-4-15b (LayerNorm, ungated squared ReLU), each on its reduced
``SMOKE`` config with the reference's weights carried across by
``params.from_reference``.  Every norm weight (``norm1``, ``norm2``,
``final_norm``, ``q_norm``, ``k_norm``) is perturbed with seeded noise
first: at their init value of zero the ``(1 + w)`` factor is 1, and a
wrong convention or a missing weight would pass.  M-RoPE is fed positions
whose three rows differ (a vision grid's t, h, w, then text positions):
with ``arange`` in all three rows, as the reference's launcher feeds it,
M-RoPE equals 1-D RoPE and a wrong section map shows nothing.

Held: the configs field by field; ``rope_tables``, qk-norm, LayerNorm
and the vision-stub merge against the reference's functions; prefill
logits and greedy decode (tokens equal, logits at the reference's
prefill bar, ``rtol=2e-4, atol=2e-4``) against its ``"xla"`` and
``"pallas_interpret"`` contexts; the loss at ``rtol=1e-5`` and every
gradient at ``rtol=1e-4, atol=1e-5`` against ``jax.value_and_grad``
(``tests/test_torch_train.py``'s bars); ``_microbatch`` on
``positions3``; gemma3's ring caches after a prefill against its full
caches; both launchers on the smoke configs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro_torch import configs as TC
from repro_torch.models import attention, layers, lm
from repro_torch.models import params as tparams
from repro_torch.models.context import ExecContext
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import steps as tsteps

ARCHS = ("gemma3_27b", "qwen2_vl_2b", "phi3_medium_14b", "nemotron_4_15b")
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
#: (reference context, port executor) pairs of the serving checks
PAIRS = [("xla", "torch"), ("pallas_interpret", "cuda")]
B, S, N_GEN = 2, 14, 6


def _perturb_norms(tree, rng):
    """Every leaf whose key names a norm, plus 0.3·N(0, 1) noise."""
    if isinstance(tree, dict):
        return {k: (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                    if "norm" in k and isinstance(v, np.ndarray)
                    else _perturb_norms(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb_norms(v, rng) for v in tree)
    return tree


def mrope_positions(b, s, starts, grid=(2, 3)):
    """(3, B, S) M-RoPE positions: row r's text before ``starts[r]``, then
    a ``grid`` of vision patches at (t, h, w) = (p, p + i, p + j) with p
    the text count before it, then text again from p + max(grid); text
    positions are equal in all three components.  Returns (positions3,
    vision_slot), slot -1 for text."""
    gh, gw = grid
    pos = np.zeros((3, b, s), np.int64)
    slot = -np.ones((b, s), np.int64)
    for r, st in enumerate(starts):
        pos[:, r, :st] = np.arange(st)
        i, j = np.divmod(np.arange(gh * gw), gw)
        v = slice(st, st + gh * gw)
        pos[0, r, v], pos[1, r, v], pos[2, r, v] = st, st + i, st + j
        slot[r, v] = np.arange(gh * gw)
        rest = s - (st + gh * gw)
        pos[:, r, st + gh * gw:] = st + max(gh, gw) + np.arange(rest)
    return pos, slot


def _np_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
          "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.vision_stub:
        pos3, slot = mrope_positions(b, s, starts=[0, 3][:b])
        nb["positions3"], nb["vision_slot"] = pos3, slot
        nb["vision_embed"] = rng.standard_normal(
            (b, 6, cfg.d_model)).astype(np.float32)
    return nb


def _jbatch(nb):
    return {k: jnp.asarray(v) if v.dtype == np.float32
            else jnp.asarray(v, jnp.int32) for k, v in nb.items()}


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """(reference config, port config, perturbed weights as numpy)."""
    cfg_j = JC.get_smoke(arch)
    params_j, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0),
                                      jnp.float32)
    np_params = _perturb_norms(jax.tree.map(np.asarray, params_j),
                               np.random.default_rng(5))
    return cfg_j, TC.get_smoke(arch), np_params


def _port_params(arch):
    _, cfg_t, np_params = _ref(arch)
    return tparams.from_reference(np_params, cfg_t, device="cpu")


def _jparams(arch):
    return jax.tree.map(jnp.asarray, _ref(arch)[2])


# ---------------------------------------------------------------------------
# configs and the new pieces, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module(arch), name)
        b = getattr(JC._module(arch), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params()
    alias = {v: k for k, v in TC.ALIASES.items()}[arch]
    assert TC.get_config(alias) is TC.get_config(arch)


def test_first_layers_keeps_width_and_pattern():
    cfg = TC.first_layers(TC.get_config("gemma3-27b"), 12)
    assert cfg.n_layers == 12 and cfg.d_model == 5376
    assert cfg.layer_program == ("local",) * 5 + ("attn",) + ("local",) * 5 \
        + ("attn",)
    # the cut quoted for the card: 12 layers, 6.37e9 float32 parameters
    assert abs(cfg.num_params() - 6.37e9) < 1e7
    with pytest.raises(ValueError, match="n_layers"):
        TC.first_layers(cfg, 13)


@pytest.mark.parametrize("theta,sections,rows", [
    (1e6, (2, 3, 3), "grid"), (1e6, (2, 3, 3), "2d"), (1e4, None, "grid"),
    (1e6, (16, 24, 24), "grid")])
def test_rope_tables_match_reference(theta, sections, rows):
    """M-RoPE on three distinct position rows, on a (B, S) input broadcast
    to all three, and standard RoPE reading a (3, B, S) input's first
    row."""
    head_dim = 2 * sum(sections) if sections else 16
    pos3, _ = mrope_positions(2, 20, starts=[0, 5], grid=(3, 4))
    assert not np.array_equal(pos3[0], pos3[1])
    assert not np.array_equal(pos3[1], pos3[2])
    pos = pos3 if rows == "grid" else pos3[1]
    want = jlayers.rope_tables(jnp.asarray(pos, jnp.int32), head_dim, theta,
                               mrope_sections=sections)
    got = layers.rope_tables(torch.from_numpy(pos), head_dim, theta,
                             mrope_sections=sections)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_mrope_section_map_reads_each_row():
    """Frequency i turns with the row of its section: (t, h, w) = (p, 0,
    0) turns only the first 2 of 8 frequencies under sections (2, 3, 3)."""
    pos = torch.zeros(3, 1, 1, dtype=torch.long)
    pos[0] = 7
    cos, _ = layers.rope_tables(pos, 16, 1e4, mrope_sections=(2, 3, 3))
    assert (cos[0, 0, :2] != 1.0).all() and (cos[0, 0, 2:] == 1.0).all()


def test_qk_norm_matches_reference():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    p = {"q_norm": rng.standard_normal(16).astype(np.float32) * 0.3,
         "k_norm": rng.standard_normal(16).astype(np.float32) * 0.3}
    want = jattention._qk_normalize(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(q), jnp.asarray(k), JCtx())
    got = attention._qk_normalize({n: torch.from_numpy(v) for n, v in p.items()},
                                  torch.from_numpy(q), torch.from_numpy(k))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_layernorm_matches_reference():
    cfg_j, cfg_t, _ = _ref("nemotron_4_15b")
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 7, cfg_t.d_model)) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal(cfg_t.d_model) * 0.3).astype(np.float32)
    want = jlayers.norm(jnp.asarray(w), jnp.asarray(x), cfg_j, JCtx())
    got = layers.norm(torch.from_numpy(w), torch.from_numpy(x), cfg_t,
                      ExecContext(backend="cuda"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_vision_stub_merge_matches_reference():
    cfg_j, cfg_t, _ = _ref("qwen2_vl_2b")
    nb = _np_batch(cfg_t, B, S, seed=10)
    want = jlm.embed_inputs(_jparams("qwen2_vl_2b"), _jbatch(nb), cfg_j,
                            JCtx())
    got = lm.embed_inputs(_port_params("qwen2_vl_2b"), _tbatch(nb), cfg_t,
                          ExecContext())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the vision slots hold the patches, the text slots the tokens
    slot = nb["vision_slot"]
    np.testing.assert_array_equal(got.numpy()[slot >= 0],
                                  nb["vision_embed"][np.nonzero(slot >= 0)[0],
                                                     slot[slot >= 0]])


def test_local_rope_table_only_with_local_layers():
    cfg = TC.get_smoke("gemma3_27b")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    rope, rope_local = lm._rope_for(batch, cfg, 4)
    assert rope_local is not None
    assert not torch.equal(rope[0], rope_local[0])
    glob = TC.first_layers(cfg, 6).scaled_down(layer_program=("attn",) * 6)
    assert lm._rope_for(batch, glob, 4)[1] is None


# ---------------------------------------------------------------------------
# serving: prefill and greedy decode against both reference contexts
# ---------------------------------------------------------------------------

def _decode_positions3(nb, i):
    """The (3, B, 1) M-RoPE positions of decode step i: one past the
    prompt's last position, in all three rows."""
    last = nb["positions3"][:, :, -1:]
    return last.max(0, keepdims=True).repeat(3, 0) + 1 + i


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, jax_backend):
    """The reference's prefill logits, then N_GEN greedy decode steps'
    logits and tokens (its prefill and decode step jitted, as its
    launcher runs them)."""
    from repro.runtime import steps as jsteps
    cfg_j, _, _ = _ref(arch)
    params_j = _jparams(arch)
    nb = _np_batch(cfg_j, B, S, seed=11)
    nb.pop("labels")
    ctx = JCtx(backend=jax_backend)
    prefill = jax.jit(functools.partial(jlm.prefill, cfg=cfg_j, ctx=ctx))
    decode = jax.jit(functools.partial(jlm.decode_step, cfg=cfg_j, ctx=ctx))
    logits, caches, _ = prefill(params_j, _jbatch(nb))
    caches = jsteps._pad_caches(caches, cfg_j, S + N_GEN + 1)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out_l, out_t = [np.asarray(logits)], [np.asarray(tok)]
    for i in range(N_GEN):
        kw = {}
        if cfg_j.pos_embed == "mrope":
            kw["positions3"] = jnp.asarray(_decode_positions3(nb, i), jnp.int32)
        logits, caches = decode(params_j, tok, caches,
                                jnp.asarray(S + i, jnp.int32), **kw)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_l.append(np.asarray(logits))
        out_t.append(np.asarray(tok))
    return nb, out_l, out_t


@pytest.mark.parametrize("jax_backend,backend", PAIRS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_reference(arch, jax_backend, backend):
    """Prefill 14 tokens (past gemma3's window of 8), then 6 greedy decode
    steps through the port's serve steps: the prefill's and every step's
    logits within the bar, the tokens identical."""
    nb, jlogits, jtokens = _jax_greedy(arch, jax_backend)
    _, cfg_t, _ = _ref(arch)
    params = _port_params(arch)
    pre, dec = tsteps.build_serve_steps(cfg_t, ExecContext(backend=backend),
                                        max_len=S + N_GEN + 1)
    tok, caches, length, logits = pre(params, _tbatch(nb))
    np.testing.assert_allclose(logits.numpy(), jlogits[0], **TOL)
    np.testing.assert_array_equal(tok.numpy(), jtokens[0])
    for i in range(N_GEN):
        p3 = (torch.from_numpy(_decode_positions3(nb, i))
              if cfg_t.pos_embed == "mrope" else None)
        tok, caches, length, logits = dec(params, tok, caches, length,
                                          positions3=p3)
        np.testing.assert_allclose(logits.numpy(), jlogits[i + 1], **TOL)
        np.testing.assert_array_equal(tok.numpy(), jtokens[i + 1])
    assert length == S + N_GEN


def test_gemma3_ring_cache_decode_matches_full_cache():
    """gemma3's local layers on window-sized ring caches after a 14-token
    prefill (window 8): every decode step's logits equal the full caches'
    within the bar, the tokens identical, and the ring caches hold 8
    slots."""
    _, cfg_t, _ = _ref("gemma3_27b")
    params = _port_params("gemma3_27b")
    nb = _np_batch(cfg_t, B, S, seed=12)
    nb.pop("labels")
    runs = {}
    for ring in (False, True):
        pre, dec = tsteps.build_serve_steps(
            cfg_t, ExecContext(backend="cuda"), max_len=S + 10,
            local_ring=ring)
        tok, caches, length, logits = pre(params, _tbatch(nb))
        out = [(tok, logits)]
        for _ in range(10):
            tok, caches, length, logits = dec(params, tok, caches, length)
            out.append((tok, logits))
        runs[ring] = (caches, out)
    caches, _ = runs[True]
    assert [c["k"].shape[2] for c in caches] == [8] * 5 + [S + 10]
    for (ta, la), (tb, lb) in zip(runs[False][1], runs[True][1]):
        np.testing.assert_allclose(lb.numpy(), la.numpy(), **TOL)
        np.testing.assert_array_equal(tb.numpy(), ta.numpy())


# ---------------------------------------------------------------------------
# training: the loss and every gradient against jax.grad
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss(arch):
    cfg_j, _, _ = _ref(arch)
    nb = _np_batch(cfg_j, B, 16, seed=13)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, cfg_j, JCtx()), has_aux=True))(
            _jparams(arch), _jbatch(nb))
    return nb, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    nb, want, gj = _jax_loss(arch)
    _, cfg_t, _ = _ref(arch)
    params = tparams.trainable(_port_params(arch))
    loss, _ = lm.loss_fn(params, _tbatch(nb), cfg_t,
                         ExecContext(backend="cuda", remat=remat))
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    loss.backward()
    grads = tparams.from_reference(gj, cfg_t, device="cpu")
    names = [n for n, _ in _leaf_paths(params)]
    for name, p, g in zip(names, tree_leaves(params), tree_leaves(grads)):
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **GRAD_TOL,
                                   err_msg=name)
    if cfg_t.attn.qk_norm:
        assert any(n.endswith("q_norm") for n in names)


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_microbatch_cuts_positions3_on_its_batch_axis():
    _, cfg_t, _ = _ref("qwen2_vl_2b")
    nb = _tbatch(_np_batch(cfg_t, 4, 12, seed=14))
    mb = tsteps._microbatch(nb, 2)
    assert tuple(mb["positions3"].shape) == (2, 3, 2, 12)
    assert tuple(mb["vision_embed"].shape) == (2, 2, 6, cfg_t.d_model)
    for j in range(2):
        rows = [i * 2 + j for i in range(2)]
        assert torch.equal(mb["positions3"][j], nb["positions3"][:, rows])
        assert torch.equal(mb["tokens"][j], nb["tokens"][rows])


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen2-vl-2b",
                                  "phi3-medium-14b", "nemotron-4-15b"])
def test_serve_cli_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x12 tokens" in out and "req1:" in out


def test_train_cli_smoke_on_cpu_qwen2_vl(tmp_path, capsys):
    from repro_torch.launch import train
    trainer, hist = train.train(train.parse_args([
        "--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu", "--steps",
        "4", "--seq-len", "16", "--global-batch", "4", "--grad-accum", "2",
        "--log-every", "1", "--ckpt-dir", str(tmp_path)]))
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert trainer.cfg.name == "qwen2-vl-smoke"
