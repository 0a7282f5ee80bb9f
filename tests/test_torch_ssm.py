"""The port's Mamba-1 serving path against the JAX package, on the CPU.

* ``ops.mamba_scan`` (the ``mamba`` site function's plain body, under the
  ``"torch"`` and ``"cuda"`` executors) against JAX's ``ops.mamba_scan``
  run as ``tests/test_kernels.py`` runs it (``backend="pallas_interpret"``)
  and its step oracle ``mamba_scan_ref``, at that file's shapes and
  tolerance ``rtol=2e-4, atol=2e-4``, plus a ragged channel count;
* the chunked scan of the ``"torch"`` backend (a doubling scan inside each
  chunk) against the step-by-step scan, with L not a multiple of the chunk;
* the cache padding of ``build_serve_steps``: only ``k``/``v`` grow, the
  Mamba state keeps its fixed shape;
* falcon-mamba's reduced config (``SMOKE``: 4 Mamba-1 layers, d 64,
  d_inner 128, d_state 8) with the JAX weights carried across by
  ``params.from_reference``: prefill logits and 8 greedy decode steps
  against the reference's ``"xla"`` and ``"pallas_interpret"`` contexts,
  for both port backends, at ``rtol=2e-4, atol=2e-4`` with identical
  tokens;
* the serve CLI on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.kernels import lm as tlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tmlm
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.context import ExecContext
from repro_torch.runtime import steps as tsteps

TOL = dict(rtol=2e-4, atol=2e-4)
BACKENDS = ("torch", "cuda")


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _scan_inputs(b, t, d, n):
    """The reference test's inputs: dt = softplus(·), a = −exp(·), d = 1."""
    x = _rand(0, (b, t, d))
    dt = np.array(jax.nn.softplus(_rand(1, (b, t, d))))
    bb, cc = _rand(2, (b, t, n)), _rand(3, (b, t, n))
    a = -np.exp(_rand(4, (d, n)))
    return x, dt, bb, cc, a, np.ones((d,), np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,t,d,n", [(1, 64, 32, 8), (2, 128, 64, 16),
                                     (1, 40, 37, 16)])
def test_mamba_scan_matches_pallas_and_ref(backend, b, t, d, n):
    args = _scan_inputs(b, t, d, n)
    want_y, want_h = jops.mamba_scan(*map(jnp.asarray, args),
                                     backend="pallas_interpret")
    ref_y, ref_h = jref.mamba_scan_ref(*map(jnp.asarray, args))
    got_y, got_h = tops.mamba_scan(*args, target=backend, device="cpu")
    assert tuple(got_y.shape) == (b, t, d) and tuple(got_h.shape) == (b, d, n)
    for got, want in ((got_y, want_y), (got_y, ref_y), (got_h, want_h),
                      (got_h, ref_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's own oracle, as the CPU tests and the chip run use it
    ty, th = tref.mamba_scan_ref(*map(torch.from_numpy, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(ref_h), **TOL)


def test_mamba_scan_vvl_is_checked_and_exact():
    """Every VVL the site function takes gives the same bits on the CPU,
    and one it does not take is refused."""
    args = _scan_inputs(1, 16, 24, 8)
    y1, h1 = tops.mamba_scan(*args, target="cuda", device="cpu")
    for vvl in (2, 4, 8):
        y2, h2 = tops.mamba_scan(*args, target="cuda", vvl=vvl, device="cpu")
        assert torch.equal(y1, y2) and torch.equal(h1, h2)
    with pytest.raises(ValueError, match="vvl in"):
        tops.mamba_scan(*args, target="cuda", vvl=128, device="cpu")


def test_mamba_site_checks():
    """What the ``"cuda"`` executor refuses before any launch: a d_state the
    site function is not instantiated for, and b/c that are not (L, N)
    tensors."""
    from repro_torch.core import Target
    from repro_torch.core import api as tapi
    from repro_torch.kernels import tdp_pointwise

    spec = tlm.mamba_scan_spec(6, 8)
    ok = dict(b=torch.zeros(6, 8), c=torch.zeros(6, 8))
    plan = tapi.launch_plan(spec, Target("cuda"), consts=ok)
    assert tdp_pointwise.cuda_site(plan) == "mamba"
    with pytest.raises(ValueError, match="as a tensor"):
        tdp_pointwise.cuda_site(tapi.launch_plan(
            spec, Target("cuda"), consts=dict(b=np.zeros((6, 8)), c=ok["c"])))
    with pytest.raises(ValueError, match="shape"):
        tdp_pointwise.cuda_site(tapi.launch_plan(
            spec, Target("cuda"), consts=dict(b=ok["b"], c=torch.zeros(6, 4))))
    args = _scan_inputs(1, 6, 5, 4)
    with pytest.raises(ValueError, match="d_state"):
        tops.mamba_scan(*args, target="cuda", device="cpu")
    y, _ = tops.mamba_scan(*args, target="torch", device="cpu")   # plain: any N
    assert tuple(y.shape) == (1, 6, 5)


def test_mamba_scan_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.mamba_scan(*_scan_inputs(1, 4, 8, 8))


@pytest.mark.parametrize("length,chunk", [(45, 16), (64, 16), (10, 128),
                                          (33, 1)])
def test_chunked_scan_matches_step_scan(length, chunk):
    x, dt, bb, cc, a, _ = map(torch.from_numpy,
                              _scan_inputs(2, length, 12, 8))
    d = torch.from_numpy(_rand(5, (12,)))
    want_y, want_h = tref.mamba_scan_ref(x, dt, bb, cc, a, d)
    got_y, got_h = tssm._chunked_scan(x, dt, bb, cc, a, d, chunk=chunk)
    torch.testing.assert_close(got_y, want_y, **TOL)
    torch.testing.assert_close(got_h, want_h, **TOL)


def test_doubling_scan_is_the_inclusive_recurrence():
    da = torch.from_numpy(np.random.default_rng(6).uniform(
        0.5, 1.0, (1, 13, 3)).astype(np.float32))
    u = torch.from_numpy(_rand(7, (1, 13, 3)))
    got_a, got_h = tssm._doubling_scan(da, u)
    h, cum = torch.zeros(1, 3), torch.ones(1, 3)
    for t in range(13):
        h = da[:, t] * h + u[:, t]
        cum = cum * da[:, t]
        torch.testing.assert_close(got_h[:, t], h, **TOL)
        torch.testing.assert_close(got_a[:, t], cum, **TOL)


# ---------------------------------------------------------------------------
# falcon-mamba's reduced config against the JAX model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg_j = JC.get_smoke("falcon_mamba_7b")
    cfg_t = TC.get_smoke("falcon-mamba-7b")
    params_j, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0),
                                      jnp.float32)
    np_params = jax.tree.map(np.asarray, params_j)
    return cfg_j, cfg_t, params_j, tparams.from_reference(np_params, cfg_t,
                                                       device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_config_copy_matches_reference():
    for name in ("CONFIG", "SMOKE"):
        a = getattr(TC._module("falcon_mamba_7b"), name)
        b = getattr(JC._module("falcon_mamba_7b"), name)
        assert repr(a) == repr(b)
        assert a.num_params() == b.num_params()
    # the full-width count quoted for the chip run: 7.273e9 float32 params
    assert abs(TC.get_config("falcon-mamba-7b").num_params() - 7.273e9) < 1e6


def test_from_reference_unstacks_the_mixer(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    assert len(params_t["layers"]) == cfg_t.n_layers
    g = params_j["groups"][0][0]
    for layer in range(cfg_t.n_layers):
        for k in g["mixer"]:
            np.testing.assert_array_equal(
                params_t["layers"][layer]["mixer"][k].numpy(),
                np.asarray(g["mixer"][k][layer]))
        np.testing.assert_array_equal(params_t["layers"][layer]["norm1"].numpy(),
                                      np.asarray(g["norm1"][layer]))
    assert set(params_t) == {"embed", "lm_head", "layers", "final_norm"}


def test_init_params_shapes_and_distributions():
    cfg = TC.get_smoke("falcon-mamba-7b")
    p = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref, _ = jparams.init_params(JC.get_smoke("falcon_mamba_7b"),
                                 jax.random.PRNGKey(0))
    ref0 = jax.tree.map(lambda t: np.asarray(t[0]), ref["groups"][0][0])
    assert set(p["layers"][0]) == set(ref0)
    mixer = p["layers"][0]["mixer"]
    assert {k: tuple(v.shape) for k, v in mixer.items()} == \
        {k: tuple(v.shape) for k, v in ref0["mixer"].items()}
    np.testing.assert_allclose(mixer["a_log"].numpy(), ref0["mixer"]["a_log"])
    np.testing.assert_array_equal(mixer["d_skip"].numpy(), 1.0)
    # dt = softplus(dt_bias) is log-uniform in [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert tuple(p["lm_head"].shape) == (cfg.d_model, cfg.padded_vocab)


def test_init_cache_matches_reference():
    cfg_t = TC.get_smoke("falcon-mamba-7b")
    want = jlm.init_cache(None, JC.get_smoke("falcon_mamba_7b"), 3, 20,
                          dtype=jnp.float32)
    got = tmlm.init_cache(cfg_t, 3, 20, dtype=torch.float32, device="cpu")
    assert len(got) == cfg_t.n_layers
    for k in ("conv", "ssm"):
        assert tuple(got[0][k].shape) == tuple(want[0][0][k].shape[1:])
        assert got[0][k].dtype == torch.float32 and not got[0][k].any()


def test_pad_caches_keeps_the_ssm_state(smoke):
    """A prefill through the serve steps with a decode budget past the
    prompt grows only k/v caches: the Mamba state keeps (B, d_conv-1, di)
    and (B, di, N)."""
    _, cfg_t, _, params_t = smoke
    s = cfg_t.ssm
    di = s.expand * cfg_t.d_model
    pre, _ = tsteps.build_serve_steps(cfg_t, ExecContext(backend="torch"),
                                      max_len=21)
    _, caches, length, _ = pre(params_t, {"tokens": torch.from_numpy(
        _tokens(cfg_t, 2, 6, seed=3))})
    assert length == 6
    for c in caches:
        assert tuple(c["conv"].shape) == (2, s.d_conv - 1, di)
        assert tuple(c["ssm"].shape) == (2, di, s.d_state)
    kv = {"k": torch.zeros(2, 2, 6, 4), "v": torch.zeros(2, 2, 6, 4)}
    padded = tsteps._pad_caches([kv, caches[0]], cfg_t, 21)
    assert tuple(padded[0]["k"].shape) == (2, 2, 21, 4)
    assert padded[1]["ssm"] is caches[0]["ssm"]


@functools.lru_cache(maxsize=None)
def _jax_greedy(jax_backend: str, b: int, s: int, n_gen: int):
    """The reference's prefill logits, then ``n_gen`` greedy decode steps'
    logits and tokens, on the smoke weights of seed 0."""
    cfg_j = JC.get_smoke("falcon_mamba_7b")
    params_j, _ = jparams.init_params(cfg_j, jax.random.PRNGKey(0),
                                      jnp.float32)
    toks = _tokens(cfg_j, b, s, seed=2)
    ctx = JCtx(backend=jax_backend)
    jpre, _ = jsteps.build_serve_steps(cfg_j, ctx, max_len=s + n_gen + 1)
    key = jax.random.PRNGKey(0)
    jtok, jcaches, jlen, _ = jpre(params_j, {"tokens": jnp.asarray(
        toks, jnp.int32)}, key)
    prefill_logits, _, _ = jlm.prefill(params_j, {"tokens": jnp.asarray(
        toks, jnp.int32)}, cfg_j, ctx)
    tokens, logits = [np.asarray(jtok)], [np.asarray(prefill_logits)]
    for _ in range(n_gen):
        jl, jcaches = jlm.decode_step(params_j, jtok, jcaches, jlen, cfg_j, ctx)
        jtok = jsteps.sample_logits(jl, key)
        jlen = jlen + 1
        logits.append(np.asarray(jl, np.float32))
        tokens.append(np.asarray(jtok))
    return toks, tokens, logits


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_greedy_serving_matches_jax(smoke, jax_backend, backend):
    """Prefill 12 tokens, then 8 greedy decode steps through both packages'
    serve steps: identical tokens, the prefill's and every step's logits
    within the bar."""
    _, cfg_t, _, params_t = smoke
    b, s, n_gen = 2, 12, 8
    toks, jtokens, jlogits = _jax_greedy(jax_backend, b, s, n_gen)
    tpre, tdec = tsteps.build_serve_steps(cfg_t, ExecContext(backend=backend),
                                          max_len=s + n_gen + 1)
    ttok, caches, tlen, tl = tpre(params_t, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), jlogits[0], **TOL)
    np.testing.assert_array_equal(ttok.numpy(), jtokens[0])
    for i in range(n_gen):
        ttok, caches, tlen, tl = tdec(params_t, ttok, caches, tlen)
        np.testing.assert_allclose(tl.numpy(), jlogits[i + 1], **TOL)
        np.testing.assert_array_equal(ttok.numpy(), jtokens[i + 1])
    assert tlen == s + n_gen


def test_decode_continues_the_prefill(smoke):
    """Prefill 10 tokens and decode the 11th: the logits of the full
    forward over 11 tokens (``tests/test_models.py::
    test_mamba_decode_matches_full`` on the port, at its own bar)."""
    _, cfg_t, _, params_t = smoke
    toks = torch.from_numpy(_tokens(cfg_t, 1, 11, seed=6))
    ctx = ExecContext(backend="cuda")
    want, _ = tmlm.prefill(params_t, {"tokens": toks}, cfg_t, ctx)
    _, caches = tmlm.prefill(params_t, {"tokens": toks[:, :10]}, cfg_t, ctx)
    got, _ = tmlm.decode_step(params_t, toks[:, 10:], caches, 10, cfg_t, ctx)
    torch.testing.assert_close(got, want, **TOL)


def test_serve_cli_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "12",
                       "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "falcon-mamba-smoke" in out and "prefill 2x12 tokens" in out
    assert "req1:" in out


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "falcon-mamba-7b", "--smoke"])
