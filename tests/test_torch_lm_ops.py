"""The port's LM ops against the JAX package's Pallas kernels, on the CPU.

Each plain twin — ``ops.rmsnorm``, every ``ops.gated_act`` kind (gated and
not), ``ops.flash_attention`` — takes the same numpy inputs as the JAX op
run as ``tests/test_kernels.py`` runs it (``backend="pallas_interpret"``),
at that file's tolerance ``rtol=2e-4, atol=2e-4``.  The port runs under its
``"torch"`` executor and under ``"cuda"`` (on CPU tensors the wrappers run
the plain versions).  Fully masked attention rows are held to the JAX
oracle ``attention_ref``, which zeroes them as the CUDA kernel does.  Also:
the dynamic-const path of ``tdp.launch`` (tensor consts keyed by shape,
not content) and the errors on the CUDA path that need no card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import Target, launch
from repro_torch.core import api as tapi
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lm as tlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tdp_pointwise

TOL = dict(rtol=2e-4, atol=2e-4)
BACKENDS = ("torch", "cuda")


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("t,d,scale_offset", [(64, 128, 0.0), (37, 64, 1.0),
                                              (5, 2304, 1.0)])
def test_rmsnorm_matches_pallas(backend, t, d, scale_offset):
    x, w = _rand(0, (t, d)), _rand(1, (d,))
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(w), scale_offset=scale_offset,
                        backend="pallas_interpret", vvl=64)
    got = tops.rmsnorm(x, w, scale_offset=scale_offset, target=backend,
                       device="cpu")
    assert tuple(got.shape) == (t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", tlm.GATED_KINDS)
@pytest.mark.parametrize("gated", [True, False])
def test_gated_act_matches_pallas(backend, kind, gated):
    u = 3.0 * _rand(2, (33, 96))
    v = _rand(3, (33, 96)) if gated else None
    want = jops.gated_act(jnp.asarray(u), None if v is None else jnp.asarray(v),
                          kind=kind, backend="pallas_interpret")
    got = tops.gated_act(u, v, kind=kind, target=backend, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_ATTN_CASES = {
    "mha": dict(shape=(2, 4, 4, 128, 128, 32), causal=True),
    "gqa": dict(shape=(2, 8, 2, 128, 128, 64), causal=False),
    "mqa": dict(shape=(2, 4, 1, 256, 256, 32), causal=True),
    "window": dict(shape=(1, 2, 2, 128, 128, 32), causal=True, window=16),
    "softcap": dict(shape=(1, 2, 2, 64, 64, 32), causal=True, softcap=30.0),
    "smoke_dh16": dict(shape=(2, 4, 2, 16, 16, 16), causal=True, window=8,
                       softcap=50.0),
    "ragged": dict(shape=(1, 2, 1, 100, 100, 32), causal=True, window=40),
    "scale": dict(shape=(1, 2, 2, 48, 48, 32), causal=True, scale=0.1),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_flash_attention_matches_pallas(backend, case):
    c = dict(_ATTN_CASES[case])
    b, hq, hkv, sq, sk, dh = c.pop("shape")
    q, k, v = (_rand(i, (b, h, s, dh))
               for i, (h, s) in enumerate([(hq, sq), (hkv, sk), (hkv, sk)]))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                backend="pallas_interpret", block_q=32,
                                block_k=32, **c)
    got = tops.flash_attention(q, k, v, target=backend, device="cpu", **c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_fully_masked_rows_are_zero():
    """Sq > Sk without causality and with a window: rows q >= Sk + window
    see no key.  The JAX oracle zeroes them; so do the port's twin and the
    CUDA kernel's row_out."""
    q, k, v = _rand(4, (1, 2, 40, 32)), _rand(5, (1, 2, 20, 32)), _rand(6, (1, 2, 20, 32))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False, window=5)
    got = tops.flash_attention(q, k, v, causal=False, window=5, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[:, :, 24:].any() and got[:, :, :24].abs().sum() > 0


def test_ops_refuse_unported_and_wrong_targets():
    q = torch.zeros(1, 2, 8, 16)
    # the chunked oracle runs since its port; a shifted query block (the
    # sequence-parallel caller) still raises
    torch.testing.assert_close(
        tops.flash_attention(q, q, q, impl="chunked", device="cpu"),
        tops.flash_attention(q, q, q, device="cpu"))
    with pytest.raises(NotImplementedError, match="sequence"):
        tops.flash_attention(q, q, q, impl="chunked", q_offset=4,
                             device="cpu")
    with pytest.raises(NotImplementedError, match="sequence"):
        tops.flash_attention(q, q, q, q_offset=4, device="cpu")
    with pytest.raises(ValueError, match="'torch' or 'cuda'"):
        tops.flash_attention(q, q, q, target="cuda_windowed", device="cpu")
    with pytest.raises(ValueError, match="'torch' or 'cuda'"):
        tops.rmsnorm(torch.zeros(2, 4), torch.zeros(4), target="cuda_windowed",
                     device="cpu")
    with pytest.raises(ValueError, match="GQA"):
        tops.flash_attention(q, torch.zeros(1, 3, 8, 16),
                             torch.zeros(1, 3, 8, 16), device="cpu")


def test_ops_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.rmsnorm(torch.zeros(2, 4), torch.zeros(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.gated_act(torch.zeros(2, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.flash_attention(torch.zeros(1, 1, 2, 16), torch.zeros(1, 1, 2, 16),
                             torch.zeros(1, 1, 2, 16))


class TestDynamicConsts:
    def test_tensor_consts_are_per_call_operands(self):
        """A new weight of the same shape reuses the plan and is used."""
        spec = tlm.rmsnorm_spec(4)
        x = torch.from_numpy(_rand(7, (4, 6)))
        tapi._build_plan.cache_clear()
        outs = []
        for seed in (8, 9):
            w = torch.from_numpy(_rand(seed, (4,)))
            outs.append(launch(spec, Target("torch"), x, weight=w, eps=1e-6,
                               scale_offset=1.0))
            np.testing.assert_allclose(
                outs[-1].numpy(),
                tref.rmsnorm_ref(x.T, w, scale_offset=1.0).T.numpy(), **TOL)
        info = tapi._build_plan.cache_info()
        assert info.misses == 1 and info.hits == 1
        assert not torch.equal(outs[0], outs[1])

    def test_signature_change_builds_a_new_plan(self):
        tapi._build_plan.cache_clear()
        for d in (4, 4, 8):
            x = torch.ones(d, 3)
            launch(tlm.rmsnorm_spec(d), Target("torch"), x,
                   weight=torch.zeros(d), eps=1e-6, scale_offset=1.0)
        assert tapi._build_plan.cache_info().misses == 2

    def test_split_consts(self):
        static, dyn = tapi._split_consts(
            {"w": torch.zeros(2), "eps": 1e-6, "table": np.zeros(3)})
        assert set(static) == {"eps", "table"} and set(dyn) == {"w"}


class TestCudaSiteChecks:
    """What the ``"cuda"`` executor checks before any launch."""

    def _plan(self, spec, **consts):
        return tapi.launch_plan(spec, Target("cuda"), consts=consts)

    def test_sites_and_acts(self):
        assert tdp_pointwise.cuda_site(self._plan(
            tlm.rmsnorm_spec(8), weight=torch.zeros(8), eps=1e-6,
            scale_offset=1.0)) == "rmsnorm"
        for kind in tlm.GATED_KINDS:
            assert tdp_pointwise.cuda_site(self._plan(
                tlm.gated_act_spec(kind, True))) == "gated"
            assert tdp_pointwise.cuda_site(self._plan(
                tlm.gated_act_spec(kind, False))) == "act"
        assert set(tlm.ACT_OF_KIND.values()) == {"silu", "gelu_tanh", "relu2"}

    def test_rmsnorm_needs_its_consts(self):
        with pytest.raises(ValueError, match="weight"):
            tdp_pointwise.cuda_site(self._plan(tlm.rmsnorm_spec(8), eps=1e-6,
                                               scale_offset=0.0))

    def test_head_dims(self):
        assert tfa.HEAD_DIMS == (16, 32, 64, 80, 128, 192, 256)

    def test_lm_site_on_cpu_runs_the_plain_body(self):
        x = torch.from_numpy(_rand(10, (1, 50)))
        got = launch(tlm.gated_act_spec("relu2", False), Target("cuda", vvl=4), x)
        np.testing.assert_allclose(got.numpy(),
                                   tref.gated_act_ref(x, kind="relu2").numpy())
