"""One bfloat16 train step of granite, deepseek-v3 (with its MTP module) and
whisper, the port against the JAX package on the CPU (ROADMAP A7.1c.1).

The reference's bfloat16 smoke weights (``init_params(..., jnp.bfloat16)``,
carried across by ``params.from_reference``, which keeps each leaf's dtype)
and the same numpy batch go through the reference's jitted ``_grads_of``
and the port's ``runtime.steps._metrics_and_grads``, under both of the
port's executors: ``"torch"`` (the plain versions) and ``"cuda"`` (on CPU
tensors the wrappers run their plain versions; their gradients are the
``torch.autograd.Function``s').  Held: the loss and the cross-entropy at
``LOSS_RTOL`` and each leaf's gradient norm at ``LEAF_NORM_RTOL``, the
gradients bfloat16 as the leaves — the bars of
``tests/test_torch_bf16_families.py::test_bf16_train_step_matches_reference``,
which holds falcon-mamba and zamba2 the same way — but where the
reference's own jitted and op-by-op runs lie further apart than
``LOSS_RTOL["torch"]``: deepseek's loss is held at ``LOSS_RTOL`` to the
reference's loss run op by op (``jax.disable_jit()``, ``OP_BY_OP``) and
at ``LOSS_RTOL["cuda"]`` to the jitted one, whisper's at
``LOSS_RTOL["cuda"]`` (``CE_APART``).  deepseek's step carries the MTP term at
``TrainHParams.mtp_weight`` (0.3 in both packages); whisper's batch its
audio frames, rounded to bfloat16 as the model's embedding rounds them.
Also the repair this step needed (ROADMAP §C): kernel 4's gradient under
``"cuda"`` (``ops._FlashFn``, its backward ``ref._chunk_bwd``) rounds where
the plain version's autograd rounds — the softmax jacobian's diagonal term
summed over the probabilities, not from the bfloat16 output, and each
query head's dk and dv rounded before a grouped-query sum.  This file
stands alone so that ``--dist loadfile`` runs it on a worker of its own.
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
from repro.runtime import TrainHParams as JHParams
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.kernels import ops as tops
from repro_torch.models import params as tparams
from repro_torch.models.context import ExecContext
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import steps as tsteps

BF = torch.bfloat16
BACKENDS = ("torch", "cuda")
ARCHS = ("granite_moe_1b_a400m", "deepseek_v3_671b", "whisper_medium")
#: step 1's loss against the reference's, relative, and each leaf's
#: gradient norm: the bars of ``test_torch_bf16_families.py``'s train step
#: (the port's backward rounds where PyTorch's autograd rounds, not where
#: XLA's cotangent casts do)
LOSS_RTOL = {"torch": 1e-6, "cuda": 1e-4}
LEAF_NORM_RTOL = 2.5e-2
#: the families whose loss is held at ``LOSS_RTOL`` to the reference's
#: loss run op by op (``jax.disable_jit()``) and at ``LOSS_RTOL["cuda"]``
#: to the jitted one (ROADMAP §C, differences of definition; measured on
#: the CPU): deepseek's jitted loss is 2.2e-5 from its op-by-op run, its
#: MTP term 5.7e-5 (XLA's fusion keeps a bfloat16 chain in float32); the
#: port's loss is 1.8e-7 from the op-by-op one, its CE 1.4e-7 from the
#: jitted CE, which is held at ``LOSS_RTOL``
OP_BY_OP = ("deepseek_v3_671b",)
#: the families whose cross-entropy and so loss are held at
#: ``LOSS_RTOL["cuda"]`` under both backends: whisper's encoder projects one
#: k element a float32 ulp apart in XLA's and PyTorch's GEMMs, and its
#: bfloat16 rounding flips, jitted or not (the port's loss 2.1e-5 from the
#: jitted reference, 3.0e-5 from the op-by-op one, which lie 9.4e-6 apart)
CE_APART = ("whisper_medium",)
#: the batch: B sequences of S tokens (and whisper's frames)
B, S = 2, 16


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.fixture(scope="module", params=ARCHS)
def step_ref(request):
    """One family's reference bfloat16 weights (seed 0) and a seeded batch:
    the reference's loss and gradients (``"xla"``, jitted), and for
    :data:`OP_BY_OP`'s families its loss run op by op."""
    arch = request.param
    cfg_j = JC.get_smoke(arch)
    pj = jparams.init_params(cfg_j, jax.random.PRNGKey(0), jnp.bfloat16)[0]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_j.vocab_size, (B, S + 1))
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}
    if cfg_j.is_encdec:
        frames = torch.from_numpy(rng.standard_normal(
            (B, cfg_j.encoder.n_frames, cfg_j.d_model)).astype(
                np.float32)).to(BF)
        nb["audio_embed"] = frames
        jb["audio_embed"] = jnp.asarray(frames.float().numpy()).astype(
            jnp.bfloat16)
    loss, grads = jax.jit(jsteps._grads_of(cfg_j, JCtx(), JHParams()))(pj, jb)
    _, aux = jax.jit(lambda p, b: jlm.loss_fn(p, b, cfg_j, JCtx()))(pj, jb)
    loss_op = None
    if arch in OP_BY_OP:
        with jax.disable_jit():
            loss_op = float(jlm.loss_fn(pj, jb, cfg_j, JCtx(), mtp_weight=(
                JHParams().mtp_weight))[0])
    return {"arch": arch, "params": _np(pj), "batch": nb,
            "loss": float(loss), "loss_op_by_op": loss_op,
            "ce": float(aux["ce"]), "grads": _np(grads)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_train_step_matches_reference(step_ref, backend):
    """The cross-entropy and the loss within ``LOSS_RTOL`` (but
    :data:`CE_APART`'s; :data:`OP_BY_OP`'s loss to the op-by-op run) and
    each leaf's gradient norm within :data:`LEAF_NORM_RTOL` of the
    reference's, every gradient bfloat16 as
    its leaf (one microbatch); deepseek's MTP module and whisper's encoder
    among the leaves, none of them zero."""
    cfg = TC.get_smoke(step_ref["arch"])
    params = tparams.trainable(tparams.from_reference(
        step_ref["params"], cfg, device="cpu"))
    batch = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
             for k, v in step_ref["batch"].items()}
    hp = tsteps.TrainHParams()
    assert hp.mtp_weight == JHParams().mtp_weight > 0
    metrics, grads = tsteps._metrics_and_grads(
        cfg, ExecContext(backend=backend), hp)(params, batch)
    arch = step_ref["arch"]
    np.testing.assert_allclose(
        float(metrics["ce"]), step_ref["ce"],
        rtol=LOSS_RTOL["cuda" if arch in CE_APART else backend])
    np.testing.assert_allclose(
        float(metrics["loss"]), step_ref["loss"],
        rtol=LOSS_RTOL["cuda" if arch in CE_APART + OP_BY_OP else backend])
    if arch in OP_BY_OP:
        np.testing.assert_allclose(float(metrics["loss"]),
                                   step_ref["loss_op_by_op"],
                                   rtol=LOSS_RTOL[backend])
    want = tree_leaves(tparams.from_reference(step_ref["grads"], cfg,
                                              device="cpu"))
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == BF and g.shape == w.shape
        assert float(w.float().norm()) > 0
        np.testing.assert_allclose(float(g.float().norm()),
                                   float(w.float().norm()),
                                   rtol=LEAF_NORM_RTOL)
    for part in ("mtp", "encoder"):
        if part in params:
            assert tree_leaves(grads[part])


#: kernel 4's bfloat16 gradients under ``"cuda"`` against the plain
#: version's (``"torch"``) on the same inputs: at most this share of dq, dk
#: and dv elements on another bfloat16 value (measured ≤ 0.51 % here; the
#: diagonal term taken from the rounded output and the group's sum in
#: float32 put 23–51 % of dq's and dk's elements apart, up to 200 bfloat16
#: steps), the share bar of the card's bfloat16 rows
GRAD_SHARE_APART = 1e-2
_ATTN_GRAD = {
    "gqa_causal": ((2, 4, 2, 96, 96, 64), dict(causal=True)),
    "noncausal_cross": ((1, 4, 4, 40, 100, 32), dict(causal=False)),
    "window_softcap_mqa": ((1, 4, 1, 100, 100, 64),
                           dict(causal=True, window=24, softcap=30.0)),
    "dh80": ((1, 2, 2, 64, 64, 80), dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(_ATTN_GRAD))
def test_flash_gradient_rounds_as_the_plain_version(case):
    """bfloat16 q, k, v and a bfloat16 output gradient: dq, dk and dv of
    ``ops.flash_attention`` under ``"cuda"`` (on CPU tensors its
    ``Function``: the plain forward, ``_chunk_bwd``) against the autograd
    of the plain version, at most :data:`GRAD_SHARE_APART` of each on
    another bfloat16 value, all finite and bfloat16."""
    (b, hq, hkv, sq, sk, dh), kw = _ATTN_GRAD[case]
    g = torch.Generator().manual_seed(11)
    q = (2 * torch.randn(b, hq, sq, dh, generator=g)).to(BF)
    k = (2 * torch.randn(b, hkv, sk, dh, generator=g)).to(BF)
    v = torch.randn(b, hkv, sk, dh, generator=g).to(BF)
    dout = torch.randn(b, hq, sq, dh, generator=g).to(BF)

    def grads(target):
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = tops.flash_attention(*xs, target=target, device="cpu", **kw)
        out.backward(dout)
        return [x.grad for x in xs]
    for got, want in zip(grads("cuda"), grads("torch")):
        assert got.dtype == want.dtype == BF
        assert torch.isfinite(got.float()).all()
        assert float((got != want).float().mean()) <= GRAD_SHARE_APART
