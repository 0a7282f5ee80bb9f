"""The port's optimizer substrate against the JAX package, on the CPU.

``warmup_cosine`` at ``rtol=1e-6``; the int8 codes and scales of
``quantize_blockwise`` bit for bit (both round half to even and divide,
scale and clamp in the same order); ``adamw_update`` — dense and 8-bit
moments, with and without clipping and decay — parameters and moments at
``rtol=1e-6`` over three steps from the same numpy inputs (an element
within 1e-6 of its leaf's largest magnitude, where it cancels to near
zero: ``_close_at_scale``).  Then the reference's own optimizer tests
(``tests/test_optim.py``) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import quant as jquant
from repro.optim import schedule as jschedule
from repro_torch.optim import (AdamWConfig, QTensor, adamw_init,
                               adamw_update, dequantize_blockwise,
                               global_norm, quantize_blockwise, warmup_cosine)
from repro_torch.optim.quant import tree_dequantize, tree_quantize
from repro_torch.optim.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-6, atol=0)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total,min_ratio", [
    (20, 100, 0.1), (0, 50, 0.0), (100, 10_000, 0.1), (5, 5, 0.3)])
def test_warmup_cosine_matches_reference(warmup, total, min_ratio):
    steps = np.arange(0, total + 10, dtype=np.int32)
    want = jschedule.warmup_cosine(jnp.asarray(steps), peak_lr=3e-4,
                                   warmup_steps=warmup, total_steps=total,
                                   min_ratio=min_ratio)
    got = warmup_cosine(_t(steps), peak_lr=3e-4, warmup_steps=warmup,
                        total_steps=total, min_ratio=min_ratio)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_warmup_then_decay():
    lr = warmup_cosine(torch.tensor([0, 10, 20, 60, 100]),
                       peak_lr=1e-3, warmup_steps=20, total_steps=100).numpy()
    assert lr[0] == 0.0
    assert lr[1] == pytest.approx(5e-4)
    assert lr[2] == pytest.approx(1e-3)
    assert lr[3] < lr[2]
    assert lr[4] == pytest.approx(1e-4, rel=1e-3)     # min_ratio·peak


# ---------------------------------------------------------------------------
# 8-bit block quantisation
# ---------------------------------------------------------------------------

#: (shape, block): 1-D, padded and exact blocks, 2-D and 3-D leads, one
#: element, a 0-d scalar, ties at .5 after scaling (the integers below).
QUANT_CASES = [((1000,), 128), ((256,), 256), ((7,), 4), ((10, 7), 16),
               ((4, 600), 256), ((3, 5, 33), 8), ((1,), 256), ((), 256),
               ("ties", 16)]


def _quant_input(shape, seed):
    rng = np.random.default_rng(seed)
    if shape == "ties":
        # absmax 127·2 per block: x / s · 127 lands on k + 0.5 exactly
        x = (np.arange(64, dtype=np.float32) - 32.0) + 0.5
        x[::16] = 127.0 * 2
        return x.reshape(4, 16)
    return (rng.standard_normal(shape) * 3).astype(np.float32)


@pytest.mark.parametrize("i", range(len(QUANT_CASES)))
def test_quantize_bit_equal_to_reference(i):
    shape, block = QUANT_CASES[i]
    x = _quant_input(shape, seed=i)
    want = jquant.quantize_blockwise(jnp.asarray(x), block)
    got = quantize_blockwise(_t(x), block)
    assert got.codes.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    back = dequantize_blockwise(got, x.shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_blockwise(want, x.shape)))


@pytest.mark.parametrize("n,block", [(1000, 128), (256, 256), (7, 4)])
def test_roundtrip_error_bounded(n, block, rng):
    """|x − deq(quant(x))| ≤ max|x|/127."""
    x = torch.from_numpy((rng.normal(size=(n,)) * 3).astype(np.float32))
    xr = dequantize_blockwise(quantize_blockwise(x, block), x.shape)
    bound = float(x.abs().max()) / 127.0 * 1.01 + 1e-9
    assert float((x - xr).abs().max()) <= bound


def test_zero_block():
    q = quantize_blockwise(torch.zeros(64), 32)
    assert float(dequantize_blockwise(q, (64,)).abs().max()) == 0.0


def test_shapes():
    """Codes keep the tensor's shape."""
    q = quantize_blockwise(torch.ones(10, 7), 16)
    assert q.codes.shape == (10, 7) and q.scale.shape == (10, 1)
    q2 = quantize_blockwise(torch.ones(4, 600), 256)
    assert q2.codes.shape == (4, 600) and q2.scale.shape == (4, 3)


def test_tree_quantize_roundtrip():
    tree = {"b": [torch.ones(3, 5), torch.zeros(4)], "a": torch.ones(2)}
    q = tree_quantize(tree, 4)
    assert isinstance(q["a"], QTensor) and isinstance(q["b"][0], QTensor)
    back = tree_dequantize(q, tree)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert torch.equal(x, y)


def test_tree_leaves_in_reference_order():
    """Leaves in the order of the reference's pytrees (dict keys sorted),
    the order ``global_norm`` sums and the checkpoint keys them in."""
    tree = {"w": np.ones(1), "b": [np.zeros(1), {"z": np.ones(2), "a": 3}]}
    assert [np.shape(x) for x in tree_leaves(tree)] == [
        np.shape(x) for x in jax.tree.leaves(tree)]
    assert list(tree_map(lambda x: x, tree)) == ["b", "w"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((24, 40)).astype(np.float32),
            "emb": rng.standard_normal((300, 16)).astype(np.float32),
            "layers": [{"norm": rng.standard_normal((16,)).astype(np.float32),
                        "k": rng.standard_normal((16, 8)).astype(np.float32)}
                       for _ in range(2)]}


ADAMW_CASES = {
    "dense": AdamWConfig(),
    "dense_no_clip_no_decay": AdamWConfig(lr=1e-2, clip_norm=0.0,
                                          weight_decay=0.0),
    "dense_tight_clip": AdamWConfig(clip_norm=0.05),
    "quant": AdamWConfig(quantize_moments=True, quant_block=16),
    "quant_256": AdamWConfig(quantize_moments=True),
}


def _close_at_scale(got, want):
    """``rtol=1e-6``, and an element within 1e-6 of its leaf's largest
    magnitude: clipping scales g by a norm summed in another order (an ulp
    apart), and a moment (or a parameter against its step) can cancel to
    near zero, where one ulp of its inputs is a large relative error."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_reference(case):
    """Three steps from the same parameters and gradients, with the
    schedule's learning rate as a tensor: parameters, dense moments and
    8-bit scales at ``rtol=1e-6`` (``_close_at_scale``), the int8 codes
    bit for bit, and the reported norm."""
    cfg = ADAMW_CASES[case]
    jcfg = jadamw.AdamWConfig(**cfg.__dict__)
    p0 = _tree(0)
    pj = jax.tree.map(jnp.asarray, p0)
    pt = tree_map(_t, p0)
    sj, st = jadamw.adamw_init(pj, jcfg), adamw_init(pt, cfg)
    for step in range(3):
        g = _tree(10 + step)
        lr = 1e-3 * (step + 1)
        pj, sj, mj = jadamw.adamw_update(
            pj, jax.tree.map(jnp.asarray, g), sj, jcfg,
            lr=jnp.asarray(lr, jnp.float32))
        pt2, st, mt = adamw_update(pt, tree_map(_t, g), st, cfg,
                                   lr=torch.tensor(lr))
        assert pt2 is pt                       # in place
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), **TOL)
        for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
            _close_at_scale(a, b)
        assert int(st["step"]) == int(sj["step"]) == step + 1
        for name in ("m", "v"):
            got = tree_leaves(st[name])
            want = jax.tree.leaves(sj[name], is_leaf=lambda x: isinstance(
                x, jquant.QTensor))
            for a, b in zip(got, want):
                if cfg.quantize_moments:
                    np.testing.assert_array_equal(a.codes.numpy(),
                                                  np.asarray(b.codes))
                    _close_at_scale(a.scale, b.scale)
                else:
                    _close_at_scale(a, b)


def _setup(quant):
    params = {"w": torch.ones(16, 16), "b": torch.zeros(16)}
    grads = {"w": torch.full((16, 16), 0.5), "b": torch.full((16,), 0.5)}
    cfg = AdamWConfig(lr=1e-2, quantize_moments=quant, quant_block=32,
                      weight_decay=0.0, clip_norm=0.0)
    return params, grads, cfg


def test_first_step_is_lr_sized():
    params, grads, cfg = _setup(False)
    p2, st2, _ = adamw_update(params, grads, adamw_init(params, cfg), cfg)
    np.testing.assert_allclose(p2["w"].numpy(), 1.0 - 1e-2, rtol=1e-3)
    assert int(st2["step"]) == 1


def test_quantized_tracks_fp32():
    """8-bit moments stay within a few % of the float32 trajectory."""
    paths = {}
    for quant in (False, True):
        params, grads, cfg = _setup(quant)
        st = adamw_init(params, cfg)
        for i in range(10):
            g = tree_map(lambda x: x * (1.0 + 0.1 * np.sin(i)), grads)
            params, st, _ = adamw_update(params, g, st, cfg)
        paths[quant] = params
    np.testing.assert_allclose(paths[True]["w"].numpy(),
                               paths[False]["w"].numpy(), rtol=0.05, atol=5e-3)


def test_clipping_reports_the_norm_before_the_clip():
    params, grads, _ = _setup(False)
    cfg = AdamWConfig(lr=1e-2, clip_norm=0.1, weight_decay=0.0)
    _, _, metrics = adamw_update(params, grads, adamw_init(params, cfg), cfg)
    assert float(metrics["grad_norm"]) > 0.1


def test_weight_decay_only_matrices():
    params = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    zero_g = tree_map(torch.zeros_like, params)
    cfg = AdamWConfig(lr=1.0, weight_decay=0.5, clip_norm=0.0)
    p2, _, _ = adamw_update(params, zero_g, adamw_init(params, cfg), cfg)
    assert float(p2["w"][0, 0]) < 1.0           # decayed
    np.testing.assert_allclose(p2["b"].numpy(), 1.0)   # vectors not


def test_update_leaves_autograd_leaves_trainable():
    """In place under no_grad: leaves that require gradients keep doing so
    and stay leaves; the dense moments are the same tensors."""
    p = {"w": torch.ones(3, 3, requires_grad=True)}
    cfg = AdamWConfig()
    st = adamw_init(p, cfg)
    m0 = st["m"]["w"]
    p2, st2, _ = adamw_update(p, {"w": torch.ones(3, 3)}, st, cfg)
    assert p2["w"].requires_grad and p2["w"].is_leaf
    assert st2["m"]["w"] is m0


def test_global_norm_matches_numpy(rng):
    tree = {"a": torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}
    want = np.sqrt(sum((v.numpy().astype(np.float64) ** 2).sum()
                       for v in tree.values()))
    np.testing.assert_allclose(float(global_norm(tree)), want, rtol=1e-6)
