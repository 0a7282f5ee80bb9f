"""bfloat16 for the Mamba, MoE, MLA and whisper families (ROADMAP A7.1b),
the port against the JAX package on the CPU.

The reference's bfloat16 weights (``init_params(..., jnp.bfloat16)``,
carried across by ``params.from_reference``) and the same numpy tokens go
through both packages, on the smoke configs:

* (a) SiLU on bfloat16 rounds where ``jax.nn.silu`` rounds (every op of
  ``x · (1 / (1 + exp(−x)))`` in bfloat16): bit for bit on seeded values;
  and every layer of zamba2 (its first a Mamba-2 mixer), granite and
  deepseek, fed the same input, within a stated count of bfloat16 flips of
  the reference's, which ``F.silu`` (the old code) and a rounding placed
  elsewhere in the MoE exceed;
* (b) falcon-mamba-7b, zamba2-2.7b, granite-moe-1b-a400m, deepseek-v3-671b
  and whisper-medium served in bfloat16: prefill logits, every cache leaf
  and four decode steps, under ``"torch"`` and ``"cuda"``, each against the
  reference's matching backend (``"xla"``, and for falcon-mamba, whose
  Pallas scan rounds dt to bfloat16 first, ``"pallas_interpret"``; the
  other four reach no Pallas kernel whose bfloat16 result differs from
  ``"xla"``'s: measured bit-equal);
* (c) ``ops.mamba_scan`` in bfloat16 against the reference's Pallas scan
  in interpret mode: y bfloat16, h float32;
* (d) attention in bfloat16 at Dh 16, 32, 64, 80 and 192 against the
  reference's kernel;
* (e) one bfloat16 train step's loss and gradients for falcon-mamba and
  zamba2 against the reference's.

Each bar is stated beside the distance measured on the CPU and lies below
a control's that must fail it.  whisper is held to the reference run op by
op (``jax.disable_jit()``): the jitted reference differs from its own
source's roundings (XLA keeps fused bfloat16 elementwise chains in float32,
ROADMAP §C), and that distance is pinned at its measured size.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as JC
from repro.kernels import ops as jops
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.context import ExecContext as JCtx
from repro.runtime import TrainHParams as JHParams
from repro.runtime import steps as jsteps
from repro_torch import configs as TC
from repro_torch.kernels import ops as tops
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.config import plan_layer_groups
from repro_torch.models.context import ExecContext
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import steps as tsteps

BF = torch.bfloat16
BACKENDS = ("torch", "cuda")
#: the port's reference backend under each of its own
MATCHING = {"torch": "xla", "cuda": "pallas_interpret"}
B, S, STEPS = 2, 24, 4
ARCHS = ("falcon_mamba_7b", "zamba2_2p7b", "granite_moe_1b_a400m",
         "deepseek_v3_671b", "whisper_medium")
#: the families whose reference backends differ in bfloat16 (the Pallas scan
#: takes dt rounded to bfloat16, the chunked scan float32: falcon-mamba's
#: smoke logits 2.9e-2 apart)
BOTH_BACKENDS = ("falcon_mamba_7b",)

#: below this, outputs are held absolutely (float32's own error where a
#: result cancels)
BF16_ATOL = 1e-5
#: the largest |Δ| of the logits against the reference, (prefill, decode
#: steps).  The prefill: falcon-mamba, deepseek and whisper (op by op)
#: round where the reference rounds, float32 reassociation only (measured
#: 4.8e-7, 2.4e-7, 6.0e-8).  zamba2 and granite: a float32 sum a ulp apart
#: lands on the other side of one bfloat16 rounding in the first layer
#: (zamba2: the SSD's sums, in another order; granite: an expert's
#: down-projection sums to an exact bfloat16 tie, which XLA's and
#: PyTorch's GEMMs round apart), and the model's own roundings carry that
#: one value to the logits (measured 2.9e-3, 3.3e-3; ROADMAP §C).  The
#: decode steps read the caches of every prompt position, where such flips
#: (softplus and exp a float32 ulp apart, the MoE's sums) land in the SSM
#: and MoE families (measured falcon-mamba 4.0e-3, zamba2 6.8e-3, granite
#: 4.5e-3, deepseek 7.2e-7 here, 1.4e-2 on other seeded tokens):
#: ``FLIP_LOGITS`` of ``test_torch_bf16.py`` at their size; whisper's
#: decode rounds where the reference's prefill over the tokens so far
#: rounds (measured 6.0e-8).  Where a flip lands depends on the data: on
#: other seeded inputs of the same sizes granite's second layer put 14
#: values off and deepseek's prefill moved by 5.8e-3.  One rounding placed
#: elsewhere moves these models' logits as far (granite: 4.6e-3 to
#: 5.4e-3), so the per-layer counts (:data:`LAYER_APART`) are what rejects
#: it; ``F.silu`` fails the prefill bars (falcon-mamba 4.1e-2, zamba2
#: 1.27e-2), the jitted reference whisper's (5.3e-3)
LOGIT_BAR = {"falcon_mamba_7b": (1e-5, 2e-2), "zamba2_2p7b": (6e-3, 2e-2),
             "granite_moe_1b_a400m": (6e-3, 2e-2),
             "deepseek_v3_671b": (1e-6, 2e-2), "whisper_medium": (1e-6, 1e-6)}
#: each layer fed the same bfloat16 input: at most this many of its 3072
#: outputs off the reference's (measured zamba2 3 in its first layer, 0
#: after; granite 1, 0, 0; deepseek 0); the controls put hundreds off
LAYER_APART = 4
#: each cache leaf, relative to its largest magnitude: the flips above
#: carried into the caches (measured falcon-mamba 5.9e-4 under "torch" and,
#: against the reference's Pallas scan, whose h it rounds to bfloat16,
#: 2.9e-3; zamba2 7.1e-3; granite 4.9e-3); deepseek's bit-equal, whisper's
#: 1.1e-6
CACHE_BAR = {"falcon_mamba_7b": 1e-2, "zamba2_2p7b": 1e-2,
             "granite_moe_1b_a400m": 1e-2, "deepseek_v3_671b": 1e-6,
             "whisper_medium": 1e-5}
#: the jitted whisper reference's distance from its op-by-op run (XLA's
#: fusions round elsewhere than its source), pinned: measured 5.3e-3
WHISPER_JIT = (1e-3, 1e-2)
#: each leaf's gradient norm, relative: the port's backward rounds where
#: PyTorch's autograd rounds, not where XLA's cotangent casts do (measured
#: up to 1.6e-2: zamba2's out_norm and shared wo, falcon-mamba's dt_bias
#: under "cuda"; the reference's own bfloat16 gradients of those leaves are
#: 1.9-22 % from its float32 ones; gemma2's bar in ``test_torch_bf16.py``
#: is 1e-2)
LEAF_NORM_RTOL = 2.5e-2
#: step 1's loss against the reference's ``"xla"`` run, relative: under
#: ``"torch"`` the same roundings (measured 7.0e-8 and 7.6e-8); under
#: ``"cuda"`` falcon-mamba's scan takes dt rounded to bfloat16, as the
#: reference's Pallas scan does and its ``"xla"`` scan does not (measured
#: 5.0e-5; the reference's own bfloat16 loss is 7.6e-5 from its float32)
LOSS_RTOL = {"torch": 1e-6, "cuda": 1e-4}


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _f32(x):
    return np.asarray(x, np.float32)


def _rand_bf16(seed, shape, scale=1.0):
    """Seeded numpy values rounded to bfloat16 once: (jax, torch) twins."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    t = torch.from_numpy(x).to(BF)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def assert_within_bf16_step(got, want):
    """``got`` within one bfloat16 step of ``want`` (the spacing at ``want``)
    or :data:`BF16_ATOL`."""
    g = torch.as_tensor(np.asarray(got, np.float32)).float()
    w = torch.as_tensor(np.asarray(want, np.float32)).float()
    assert torch.isfinite(g).all()
    exp = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    bar = torch.exp2(exp - 7).clamp_min(BF16_ATOL)
    assert bool(((g - w).abs() <= bar).all()), float(
        ((g - w).abs() / bar).max())


# ---------------------------------------------------------------------------
# (a) SiLU
# ---------------------------------------------------------------------------

def test_silu_rounds_as_the_reference():
    """20 000 seeded bfloat16 values: ``ssm._silu`` bit for bit with
    ``jax.nn.silu``; ``F.silu`` (one rounding) differs on about a third;
    float32 stays ``F.silu`` bit for bit."""
    xj, xt = _rand_bf16(0, (20_000,), 4.0)
    want = _f32(jax.nn.silu(xj))
    np.testing.assert_array_equal(tssm._silu(xt).float().numpy(), want)
    assert (F.silu(xt).float().numpy() != want).sum() > 5000
    x32 = xt.float()
    assert torch.equal(tssm._silu(x32), F.silu(x32))


# ---------------------------------------------------------------------------
# (b) serving the families in bfloat16
# ---------------------------------------------------------------------------

def _batches(cfg_j, toks):
    bj = {"tokens": jnp.asarray(toks, jnp.int32)}
    bt = {"tokens": torch.from_numpy(toks)}
    if cfg_j.is_encdec:
        ae = np.random.default_rng(2).standard_normal(
            (B, cfg_j.encoder.n_frames, cfg_j.d_model)).astype(np.float32)
        bt["audio_embed"] = torch.from_numpy(ae).to(BF)
        bj["audio_embed"] = jnp.asarray(bt["audio_embed"].float().numpy()
                                        ).astype(jnp.bfloat16)
    return bj, bt


def _ref_serve(pj, cfg_j, bj, cont, jbackend, decode=True):
    """The reference's bfloat16 prefill (logits, caches padded for the
    decode steps) and the logits of STEPS decode steps fed the tokens
    ``cont`` (B, STEPS) (none with ``decode=False``): its jitted prefill
    and ``decode_step``, as its serve steps run them (on these inputs
    bit-equal to its run op by op), for the decoder-only families; for
    whisper, op by op, its prefill over the prompt and ``cont`` at once,
    read at the positions from S − 1 (its ``decode_step`` gives the token
    row 0's position, ROADMAP §C; the decoder is causal, so each
    position's logits are a prefill's over the tokens so far)."""
    ctx = JCtx(backend=jbackend)

    def prefill(p, b):
        return jlm.prefill(p, b, cfg_j, ctx)[:2]
    if cfg_j.is_encdec:
        # its prefill's steps over the prompt and ``cont`` at once: the
        # positions before S give the prompt's prefill bit for bit (its
        # logits and caches; measured)
        with jax.disable_jit():
            full = dict(bj, tokens=jnp.concatenate([bj["tokens"], cont], 1))
            x, caches = jlm._apply_stack(
                pj["groups"], cfg_j.layer_program,
                jlm.embed_inputs(pj, full, cfg_j, ctx), cfg_j, ctx,
                rope=None, rope_local=None, shared=None,
                enc_out=jlm.encode(pj, full, cfg_j, ctx), collect_cache=True)
            lg = jlayers.logits_from_hidden(
                pj, jlayers.norm(pj["final_norm"], x, cfg_j, ctx)[:, S - 1:],
                cfg_j)
        caches = jax.tree_util.tree_map_with_path(
            lambda path, t: t[..., :S, :] if jax.tree_util.keystr(
                path).endswith("['self']['k']") or jax.tree_util.keystr(
                    path).endswith("['self']['v']") else t, caches)
        logits = lg[:, :1]
        steps = [_f32(lg[:, i + 1:i + 2]) for i in range(STEPS)]
    else:
        logits, caches = jax.jit(prefill)(pj, bj)
        dec = jax.jit(lambda p, t, c, n: jlm.decode_step(p, t, c, n, cfg_j,
                                                         ctx))
        jc, steps = jsteps._pad_caches(caches, cfg_j, S + STEPS), []
        for i in range(STEPS if decode else 0):
            lg, jc = dec(pj, cont[:, i:i + 1], jc, jnp.asarray(S + i,
                                                              jnp.int32))
            steps.append(_f32(lg))
    return (_f32(logits), _np(jsteps._pad_caches(caches, cfg_j, S + STEPS)),
            steps)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's bfloat16 smoke weights of ``arch`` (seed 0)."""
    return jparams.init_params(JC.get_smoke(arch), jax.random.PRNGKey(0),
                               jnp.bfloat16)[0]


@functools.lru_cache(maxsize=None)
def _served(arch):
    """The reference's bfloat16 serving of one family on its bfloat16
    weights, under each backend the port is held to: a prompt of S seeded
    tokens, then STEPS seeded tokens decoded."""
    cfg_j, cfg_t = JC.get_smoke(arch), TC.get_smoke(arch)
    pj = _ref_params(arch)
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S))
    cont = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (B, STEPS))
    bj, bt = _batches(cfg_j, toks)
    # under "pallas_interpret" falcon-mamba's decode steps are taken from
    # the port's caches (_ref_decode)
    runs = {jb: _ref_serve(pj, cfg_j, bj, jnp.asarray(cont, jnp.int32), jb,
                           decode=jb == "xla")
            for jb in (("xla", "pallas_interpret") if arch in BOTH_BACKENDS
                       else ("xla",))}
    out = {"arch": arch, "cfg": cfg_t, "cfg_j": cfg_j, "pj": pj,
           "batch": bt, "cont": cont, "runs": runs,
           "params": tparams.from_reference(_np(pj), cfg_t, device="cpu")}
    if cfg_j.is_encdec:
        out["jitted"] = _f32(jax.jit(lambda p, b: jlm.prefill(
            p, b, cfg_j, JCtx())[0])(pj, bj))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    return _served(request.param)


def _cache_pairs(cfg, got, want):
    """(path, port leaf, reference leaf) of every cache leaf, the
    reference's laid out by its scan groups."""
    offset = 0
    for g, (unit, k) in enumerate(plan_layer_groups(cfg.layer_program)):
        for r in range(k):
            for j in range(len(unit)):
                i = offset + r * len(unit) + j
                w = jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(lambda x: x[r], want[g][j]))
                p = jax.tree_util.tree_leaves_with_path(jax.tree.map(
                    lambda t: t.float().numpy(), got[i]))
                assert [a for a, _ in w] == [a for a, _ in p], i
                for (path, wl), (_, pl) in zip(w, p):
                    yield f"{i}{jax.tree_util.keystr(path)}", pl, wl
        offset += k * len(unit)


def _ref_decode(served, caches):
    """The reference's decode steps (its ``decode_step``, plain ``jnp``
    under every backend) from the port's prefill caches, fed ``cont``:
    falcon-mamba under ``"cuda"``, whose reference scan rounds the state it
    leaves in the cache to bfloat16 where the port keeps float32 (ROADMAP
    §C)."""
    cfg_j, pj = served["cfg_j"], served["pj"]
    jc = [[jax.tree.map(lambda *ls: jnp.asarray(np.stack(
        [t.float().numpy() for t in ls])).astype(
            jnp.float32 if ls[0].dtype == torch.float32 else jnp.bfloat16),
        *[caches[offset + r * len(unit) + j] for r in range(k)])
        for j in range(len(unit))]
        for (unit, k), offset in _group_offsets(served["cfg"])]
    dec = jax.jit(lambda p, t, c, n: jlm.decode_step(
        p, t, c, n, cfg_j, JCtx(backend="pallas_interpret")))
    out = []
    for i in range(STEPS):
        lg, jc = dec(pj, jnp.asarray(served["cont"][:, i:i + 1], jnp.int32),
                     jc, jnp.asarray(S + i, jnp.int32))
        out.append(_f32(lg))
    return out


def _group_offsets(cfg):
    offset = 0
    for unit, k in plan_layer_groups(cfg.layer_program):
        yield (unit, k), offset
        offset += k * len(unit)


def _assert_sure_tokens_equal(tok, want_lg, bar):
    """The port's greedy token is the reference's argmax wherever the
    reference's top-2 margin exceeds twice the logits bar."""
    flat = want_lg.reshape(B, -1)
    top2 = np.sort(flat, -1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * bar
    assert (tok.numpy().reshape(B)[sure] == flat.argmax(-1)[sure]).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_families_serve_as_the_reference(served, backend):
    """Prefill logits, every cache leaf (bfloat16 but the SSM states,
    float32) and STEPS decode steps fed the same tokens, against the
    matching reference backend at :data:`LOGIT_BAR` and :data:`CACHE_BAR`;
    the port's greedy tokens are the reference's wherever its top-2 margin
    exceeds twice the bar."""
    arch, cfg = served["arch"], served["cfg"]
    jb = MATCHING[backend] if arch in BOTH_BACKENDS else "xla"
    want_logits, want_caches, want_steps = served["runs"][jb]
    pre_bar, dec_bar = LOGIT_BAR[arch]
    pre, dec = tsteps.build_serve_steps(cfg, ExecContext(backend=backend),
                                        max_len=S + STEPS)
    tok, caches, length, logits = pre(served["params"], served["batch"])
    np.testing.assert_allclose(logits.float().numpy(), want_logits, rtol=0,
                               atol=pre_bar)
    _assert_sure_tokens_equal(tok, want_logits, pre_bar)
    for path, got, want in _cache_pairs(cfg, caches, want_caches):
        np.testing.assert_allclose(
            got, np.asarray(want, np.float32), rtol=0,
            atol=CACHE_BAR[arch] * max(np.abs(want).max(), 1e-30),
            err_msg=path)
    if arch in BOTH_BACKENDS and backend == "cuda":
        # from the same caches the decode steps agree as the prefill does
        # (measured 9.5e-7)
        want_steps, dec_bar = _ref_decode(served, caches), pre_bar
    for i, want_lg in enumerate(want_steps):
        tok, caches, length, lg = dec(
            served["params"], torch.from_numpy(served["cont"][:, i:i + 1]),
            caches, length)
        np.testing.assert_allclose(lg.float().numpy(), want_lg, rtol=0,
                                   atol=dec_bar)
        _assert_sure_tokens_equal(tok, want_lg, dec_bar)
    if "jitted" in served:
        # whisper: the reference jitted is WHISPER_JIT from its op-by-op
        # run, and so from the port
        for ref in (want_logits, logits.float().numpy()):
            d = np.abs(served["jitted"] - ref).max()
            assert WHISPER_JIT[0] < d < WHISPER_JIT[1], d


def _bf16_combine(contrib, w_flat, t, k, dtype):
    """The control of granite's bar: the MoE's weighted sum over the K
    choices rounded to bfloat16 at each choice (a rounding the reference
    does not make; it sums in float32)."""
    d = contrib.shape[-1]
    c = contrib.reshape(t, k, d) * w_flat.to(dtype).reshape(t, k, 1)
    out = c[:, 0]
    for j in range(1, k):
        out = out + c[:, j]
    return out


#: the layer each control is shown to fail on: zamba2's first Mamba-2
#: mixer, the first MoE layer of granite and deepseek
CONTROL_LAYER = {"zamba2_2p7b": 0, "granite_moe_1b_a400m": 0,
                 "deepseek_v3_671b": 1}


@functools.lru_cache(maxsize=None)
def _ref_block(cfg_j, btype):
    """The reference's ``apply_block`` for ``btype``, jitted once."""
    return jax.jit(lambda bp, x, shared, rope, rope_local: jblocks.apply_block(
        btype, bp, x, cfg=cfg_j, ctx=JCtx(), shared=shared, rope=rope,
        rope_local=rope_local)[0])


def _layers_apart(served, layers):
    """Layers ``layers`` of the port's bfloat16 prefill, each fed the port's
    input to it, through both packages' ``apply_block`` (the reference's
    jitted; op by op it gives the same values): how many of each one's
    outputs differ from the reference's."""
    cfg, cfg_j, pj, pt = (served[k] for k in ("cfg", "cfg_j", "pj", "params"))
    ctx = ExecContext(backend="torch")
    bt = served["batch"]
    bj = {"tokens": jnp.asarray(bt["tokens"].numpy(), jnp.int32)}
    x = tlm.embed_inputs(pt, bt, cfg, ctx)
    rope, rope_local = tlm._rope_for(bt, cfg, S)
    jrope, jrope_local = jlm._rope_for(bj, cfg_j, S)
    apart = {}
    for g, ((unit, k), offset) in enumerate(_group_offsets(cfg)):
        for r in range(k):
            for j, btype in enumerate(unit):
                i = offset + r * len(unit) + j
                y = tblocks.apply_block(
                    btype, pt["layers"][i], x, cfg=cfg, ctx=ctx,
                    shared=pt.get("shared_block"), rope=rope,
                    rope_local=rope_local)[0]
                if i in layers:
                    want = _ref_block(cfg_j, btype)(
                        jax.tree.map(lambda t: t[r], pj["groups"][g][j]),
                        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                        pj.get("shared_block"), jrope, jrope_local)
                    apart[i] = int((y.float().numpy() != _f32(want)).sum())
                x = y
    return apart


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "granite_moe_1b_a400m",
                                  "deepseek_v3_671b"])
def test_layers_within_a_count_of_the_reference(arch, monkeypatch):
    """Every layer on the same bfloat16 input gives at most
    :data:`LAYER_APART` outputs off the reference's (zamba2's first layer
    is one Mamba-2 mixer); the controls put far more off at
    :data:`CONTROL_LAYER`: ``F.silu`` in the Mamba-2 mixer (zamba2), the
    MoE's sum over its choices rounded to bfloat16 (granite, deepseek)."""
    from repro_torch.models import moe as tmoe
    served = _served(arch)
    every = range(len(served["cfg"].layer_program))
    assert max(_layers_apart(served, every).values()) <= LAYER_APART
    if arch == "zamba2_2p7b":
        monkeypatch.setattr(tssm, "_silu", F.silu)
    else:
        monkeypatch.setattr(tmoe, "_combine", _bf16_combine)
    control = _layers_apart(served, (CONTROL_LAYER[arch],))
    assert control[CONTROL_LAYER[arch]] > 100


# ---------------------------------------------------------------------------
# (c) the mamba site, (d) attention at every head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nstate", [8, 16])
def test_mamba_scan_bf16_matches_pallas(backend, nstate):
    """``ops.mamba_scan`` on bfloat16 x, dt, b, c and float32 a, d against
    the reference's Pallas scan in interpret mode: y bfloat16 within one
    bfloat16 step (measured bit-equal), h float32 within one bfloat16 step
    of the reference's (its executor returns h in x's dtype, bfloat16:
    ROADMAP §C) and at float32's bar of the float32 scan of the same
    values."""
    b, length, d = 2, 37, 96
    rng = np.random.default_rng(nstate)
    (xj, xt), (bj_, bt_), (cj, ct) = (
        _rand_bf16(s, shape) for s, shape in (
            (1, (b, length, d)), (2, (b, length, nstate)),
            (3, (b, length, nstate))))
    dtj, dtt = _rand_bf16(4, (b, length, d))
    dtt = F.softplus(dtt.float()).to(BF)
    dtj = jnp.asarray(dtt.float().numpy()).astype(jnp.bfloat16)
    a = -np.exp(rng.standard_normal((d, nstate))).astype(np.float32)
    dd = rng.standard_normal(d).astype(np.float32)
    yj, hj = jops.mamba_scan(xj, dtj, bj_, cj, jnp.asarray(a), jnp.asarray(dd),
                             backend="pallas_interpret")
    y, h = tops.mamba_scan(xt, dtt, bt_, ct, torch.from_numpy(a),
                           torch.from_numpy(dd), target=backend,
                           device="cpu")
    assert y.dtype == BF and h.dtype == torch.float32
    assert_within_bf16_step(y.float(), _f32(yj))
    assert_within_bf16_step(h, _f32(hj))
    y32, h32 = tops.mamba_scan(*(t.float() for t in (xt, dtt, bt_, ct)),
                               torch.from_numpy(a), torch.from_numpy(dd),
                               target=backend, device="cpu")
    assert torch.equal(y, y32.to(BF))
    torch.testing.assert_close(h, h32, rtol=1e-6, atol=1e-6)


_ATTN_BF16 = {
    "smoke_window_softcap_dh16": dict(shape=(2, 4, 2, 40, 40, 16),
                                      causal=True, window=12, softcap=5.0),
    "gqa_dh32": dict(shape=(1, 4, 2, 48, 48, 32), causal=True),
    "granite_dh64": dict(shape=(2, 4, 2, 64, 64, 64), causal=True),
    "whisper_cross_dh64": dict(shape=(1, 4, 4, 24, 80, 64), causal=False),
    "zamba2_dh80": dict(shape=(1, 4, 4, 64, 64, 80), causal=True),
    "deepseek_dh192": dict(shape=(1, 2, 2, 48, 48, 192), causal=True,
                           scale=192 ** -0.5),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(_ATTN_BF16))
def test_attention_bf16_other_head_dims(backend, case):
    """Attention in bfloat16 at the head dims kernel 4 takes now, against
    the reference's kernel in interpret mode: within one bfloat16 step of
    its output."""
    c = dict(_ATTN_BF16[case])
    b, hq, hkv, sq, sk, dh = c.pop("shape")
    (qj, qt), (kj, kt), (vj, vt) = (
        _rand_bf16(20 + i, (b, h, s_, dh))
        for i, (h, s_) in enumerate([(hq, sq), (hkv, sk), (hkv, sk)]))
    want = jops.flash_attention(qj, kj, vj, backend="pallas_interpret",
                                block_q=16,
                                block_k=16, **c)
    got = tops.flash_attention(qt, kt, vt, target=backend, device="cpu", **c)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_within_bf16_step(got.float(), _f32(want))


# ---------------------------------------------------------------------------
# (e) a train step in bfloat16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["falcon_mamba_7b", "zamba2_2p7b"])
def step_ref(request):
    """One family's bfloat16 weights, 2 × 16 tokens: the reference's loss
    and gradients (``"xla"``, jitted)."""
    arch = request.param
    cfg_j, pj = JC.get_smoke(arch), _ref_params(arch)
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (2, 17))
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}
    loss, grads = jax.jit(jsteps._grads_of(cfg_j, JCtx(), JHParams()))(pj, jb)
    return {"arch": arch, "params": _np(pj), "batch": nb,
            "loss": float(loss), "grads": _np(grads)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_train_step_matches_reference(step_ref, backend):
    """The loss within ``LOSS_RTOL`` and each leaf's gradient norm within
    :data:`LEAF_NORM_RTOL` of the reference's, the gradients bfloat16 as
    the leaves (one microbatch)."""
    cfg = TC.get_smoke(step_ref["arch"])
    params = tparams.trainable(tparams.from_reference(
        step_ref["params"], cfg, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in step_ref["batch"].items()}
    metrics, grads = tsteps._metrics_and_grads(
        cfg, ExecContext(backend=backend), tsteps.TrainHParams())(params,
                                                                  batch)
    np.testing.assert_allclose(float(metrics["loss"]), step_ref["loss"],
                               rtol=LOSS_RTOL[backend])
    want_g = tparams._unstack(step_ref["grads"], cfg, lambda tree, r:
                              tparams._to_torch(tree, "cpu", index=r,
                                                dtype=torch.float32))
    for got, want in zip(tree_leaves(grads), tree_leaves(want_g)):
        assert got.dtype == BF
        np.testing.assert_allclose(float(got.float().norm()),
                                   float(want.norm()), rtol=LEAF_NORM_RTOL)
