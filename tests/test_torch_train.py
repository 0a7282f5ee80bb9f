"""The port's training path against the JAX package, on the CPU.

Held on the same numpy inputs, with the weights (and the optimiser state)
carried across by ``params.from_reference`` /
``from_reference_opt_state``:

* ``cross_entropy`` (with and without a mask) and ``lm.loss_fn`` on the
  reference's gemma2 and falcon-mamba smoke configs, under both of the
  port's executors: the loss at ``rtol=1e-5``, every leaf's gradient
  against ``jax.value_and_grad`` at ``rtol=1e-4, atol=1e-5``; layer
  remat (``remat="block"``) gives the gradients of ``"none"`` bit for bit;
* one ``build_train_step`` step on TINY (``tests/test_runtime.py``'s
  config), gradient accumulation 1 and 2: the loss
  at ``rtol=1e-5``, the gradient norm at ``rtol=1e-4``, the parameters at
  the reference's own accumulation bar (``rtol=2e-3, atol=2e-4``,
  ``tests/test_runtime.py::test_grad_accum_equivalence``);
* the port's ``Trainer`` against the reference's over 3 steps from the
  same parameters and optimiser state: losses at ``rtol=1e-4``,
  parameters at that bar;
* the reference's runtime tests (``tests/test_runtime.py``) on the port:
  the loss falls, accumulation equivalence, restart continuation bit for
  bit, a dead peer triggers the restart loop, the straggler monitor and
  the heartbeat (whose files the reference's ``Heartbeat`` reads);
* ``launch.train`` on the smoke config, and the ``NotImplementedError`` of
  what is not ported: a mesh, ``compress_pod``, multi-token prediction;
  a ``param_dtype`` other than float32 and bfloat16 raises ``ValueError``
  (bfloat16 training: ``tests/test_torch_bf16.py``).

The reference's trainer and steps are jitted once per module (fixtures).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import SyntheticConfig as JData
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models.config import AttnConfig as JAttn
from repro.models.config import ModelConfig as JModel
from repro.models.config import repeat_program as jrepeat
from repro.models.context import ExecContext as JCtx
from repro.optim import AdamWConfig as JAdamW
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro.runtime import TrainHParams as JHParams
from repro.runtime import steps as jsteps
from repro.runtime.monitor import Heartbeat as JHeartbeat
from repro_torch import configs as TC
from repro_torch.checkpoint import latest_step
from repro_torch.data import SyntheticConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, lm
from repro_torch.models import params as tparams
from repro_torch.models.config import AttnConfig, ModelConfig, repeat_program
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig, QTensor, adamw_init
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import (Heartbeat, StragglerMonitor, Trainer,
                                 TrainerConfig, TrainHParams)
from repro_torch.runtime.monitor import PeerFailure
from repro_torch.runtime.steps import _microbatch, build_train_step

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)

TINY = ModelConfig(
    name="tiny", d_model=32, n_layers=2, vocab_size=64, d_ff=64,
    layer_program=repeat_program(("attn",), 2), attn=AttnConfig(2, 2, 16))
JTINY = JModel(
    name="tiny", d_model=32, n_layers=2, vocab_size=64, d_ff=64,
    layer_program=jrepeat(("attn",), 2), attn=JAttn(2, 2, 16))
DATA = SyntheticConfig(vocab_size=64, seq_len=16, global_batch=4, seed=1)
JDATA = JData(vocab_size=64, seq_len=16, global_batch=4, seed=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(np_params, cfg):
    return tparams.trainable(tparams.from_reference(np_params, cfg,
                                                    device="cpu"))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))}


def _jbatch(nb):
    return {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}


def _tbatch(nb):
    return {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in nb.items()}


def _close_trees(port_tree, ref_np_tree, cfg, **tol):
    """Port leaves against the reference's, unstacked to the port's
    per-layer structure."""
    want = tparams.from_reference(ref_np_tree, cfg, device="cpu")
    for a, b in zip(tree_leaves(port_tree), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **tol)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7))
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, jgrad = jax.value_and_grad(lambda x: jlayers.cross_entropy(
        x, jnp.asarray(labels, jnp.int32), jmask))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = layers.cross_entropy(x, torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


ARCHS = ("gemma2_2b", "falcon_mamba_7b")


@pytest.fixture(scope="module")
def loss_refs():
    """Per smoke arch: (cfg_t, reference params as numpy, batch, reference
    loss, reference gradients as numpy)."""
    out = {}
    for arch in ARCHS:
        cj = JC.get_smoke(arch)
        pj, _ = jparams.init_params(cj, jax.random.PRNGKey(0), jnp.float32)
        nb = _batch(cj, 2, 16, seed=4)
        nb["loss_mask"] = (np.arange(16)[None, :] < 13).astype(np.float32) \
            * np.ones((2, 1), np.float32)
        jb = {**_jbatch({k: nb[k] for k in ("tokens", "labels")}),
              "loss_mask": jnp.asarray(nb["loss_mask"])}
        (lj, _), gj = jax.jit(jax.value_and_grad(
            lambda p, b, cj=cj: jlm.loss_fn(p, b, cj, JCtx()),
            has_aux=True))(pj, jb)
        out[arch] = (TC.get_smoke(arch), _np(pj), nb, float(lj), _np(gj))
    return out


def _port_loss(loss_refs, arch, ctx):
    cfg, npj, nb, _, _ = loss_refs[arch]
    params = _port_params(npj, cfg)
    batch = {**_tbatch({k: nb[k] for k in ("tokens", "labels")}),
             "loss_mask": torch.from_numpy(nb["loss_mask"])}
    loss, metrics = lm.loss_fn(params, batch, cfg, ctx)
    loss.backward()
    return params, loss, metrics


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(loss_refs, arch, backend):
    cfg, _, _, want, gj = loss_refs[arch]
    params, loss, metrics = _port_loss(loss_refs, arch,
                                       ExecContext(backend=backend))
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    assert metrics["ce"] is metrics["loss"] is loss
    grads = tparams.from_reference(gj, cfg, device="cpu")
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert p.grad is not None
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_gives_the_same_grads(loss_refs, arch):
    a, la, _ = _port_loss(loss_refs, arch, ExecContext(remat="none"))
    b, lb, _ = _port_loss(loss_refs, arch, ExecContext(remat="block"))
    assert la.item() == lb.item()
    for p, q in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(p.grad, q.grad)


def test_bad_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        ExecContext(remat="layer")


# ---------------------------------------------------------------------------
# optimiser state across, and one train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_from_reference_opt_state(loss_refs, quant):
    """The reference's moments unstacked like its parameters (gemma2's
    smoke config: two scan groups' positions): the leaves and shapes of
    the port's own ``adamw_init``; 8-bit codes bit-equal."""
    from repro.optim import adamw as jadamw
    ct, pj = loss_refs["gemma2_2b"][:2]
    jcfg = jadamw.AdamWConfig(quantize_moments=quant)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.25), pj)
    _, sj, _ = jax.jit(lambda p, g: jadamw.adamw_update(
        p, g, jadamw.adamw_init(p, jcfg), jcfg))(pj, grads)
    st = tparams.from_reference_opt_state(_np(sj), ct, device="cpu")
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    own = adamw_init(_port_params(pj, ct), AdamWConfig(
        quantize_moments=quant))
    for name in ("m", "v"):
        got, shapes = tree_leaves(st[name]), tree_leaves(own[name])
        assert len(got) == len(shapes)
        for a, b in zip(got, shapes):
            if quant:
                assert isinstance(a, QTensor) and a.codes.dtype == torch.int8
                assert a.codes.shape == b.codes.shape
                assert a.scale.shape == b.scale.shape
            else:
                assert a.dtype == torch.float32 and a.shape == b.shape
    if quant:
        j_codes = np.asarray(sj["m"]["groups"][0][1]["attn"]["wq"].codes[1])
        np.testing.assert_array_equal(
            st["m"]["layers"][3]["attn"]["wq"].codes.numpy(), j_codes)


@pytest.fixture(scope="module")
def step_refs():
    """TINY: the reference's params and one train step at accumulation 1
    and 2 (jitted once each)."""
    from repro.optim import adamw as jadamw
    cj = JTINY
    pj, _ = jparams.init_params(cj, jax.random.PRNGKey(1), jnp.float32)
    nb = _batch(cj, 4, 16, seed=6)
    out = {"params": _np(pj), "batch": nb}
    for n in (1, 2):
        hp = JHParams(grad_accum=n, warmup_steps=2, total_steps=10)
        step = jax.jit(jsteps.build_train_step(cj, JCtx(), JAdamW(), hp))
        opt = jadamw.adamw_init(pj, JAdamW())
        p2, _, m = step(pj, opt, _jbatch(nb))
        out[n] = (_np(p2), {k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(step_refs, accum):
    cfg = TINY
    params = _port_params(step_refs["params"], cfg)
    hp = TrainHParams(grad_accum=accum, warmup_steps=2, total_steps=10)
    step = build_train_step(cfg, ExecContext(remat="block"), AdamWConfig(),
                            hp)
    p2, opt, m = step(params, adamw_init(params, AdamWConfig()),
                      _tbatch(step_refs["batch"]))
    want_p, want_m = step_refs[accum]
    np.testing.assert_allclose(float(m["loss"]), want_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), want_m["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), want_m["lr"], rtol=1e-6)
    assert int(opt["step"]) == 1
    assert all(p.grad is None for p in tree_leaves(p2))
    _close_trees(p2, want_p, cfg, **PARAM_TOL)


def test_microbatches_are_strided():
    x = torch.arange(8)[:, None].expand(8, 3)
    mb = _microbatch({"tokens": x}, 2)["tokens"]
    assert mb.shape == (2, 4, 3)
    assert mb[0, :, 0].tolist() == [0, 2, 4, 6]
    assert mb[1, :, 0].tolist() == [1, 3, 5, 7]


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def make_trainer(tmp, **kw):
    hp = TrainHParams(grad_accum=kw.pop("grad_accum", 1), warmup_steps=2,
                      total_steps=100)
    tc = TrainerConfig(ckpt_dir=str(tmp), ckpt_every=kw.pop("ckpt_every", 5),
                       log_every=kw.pop("log_every", 100),
                       hb_dir=kw.pop("hb_dir", None), log=lambda *_: None,
                       **kw)
    return Trainer(TINY, None, DATA, AdamWConfig(), hp, tc, device="cpu")


@pytest.fixture(scope="module")
def ref_trainer(tmp_path_factory):
    """The reference's trainer on TINY: its initial parameters and
    optimiser state, then 3 steps (losses and parameters)."""
    hp = JHParams(warmup_steps=2, total_steps=100)
    tc = JTrainerConfig(ckpt_dir=str(tmp_path_factory.mktemp("jref")),
                        ckpt_every=1000, log_every=1, log=lambda *_: None)
    tr = JTrainer(JTINY, None, JDATA, JAdamW(), hp, tc)
    init = (_np(tr.params), _np(tr.opt_state))
    tr.train_steps(3)
    return init, [h["loss"] for h in tr.metrics_history], _np(tr.params)


def test_trainer_matches_reference(ref_trainer, tmp_path):
    (np_params, np_opt), losses, final = ref_trainer
    tr = make_trainer(tmp_path, ckpt_every=1000, log_every=1)
    tr.params = _port_params(np_params, TINY)
    tr.opt_state = tparams.from_reference_opt_state(np_opt, TINY,
                                                    device="cpu")
    tr.train_steps(3)
    got = [h["loss"] for h in tr.metrics_history]
    assert [h["step"] for h in tr.metrics_history] == [1, 2, 3]
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    _close_trees(tr.params, final, TINY, **PARAM_TOL)


def test_trainer_defaults_and_not_ported(tmp_path):
    tr = make_trainer(tmp_path, ckpt_every=1000)
    assert tr.ctx == ExecContext(backend="cuda", remat="block")
    assert all(p.requires_grad for p in tree_leaves(tr.params))
    assert tr.device.type == "cpu"
    hp, tc = TrainHParams(), TrainerConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A7.7"):
        Trainer(TINY, object(), DATA, AdamWConfig(), hp, tc, device="cpu")
    with pytest.raises(NotImplementedError, match="A7.7"):
        Trainer(TINY, None, DATA, AdamWConfig(),
                TrainHParams(compress_pod=True), tc, device="cpu")
    with pytest.raises(ValueError, match="param_dtype"):
        Trainer(TINY, None, DATA, AdamWConfig(), hp,
                TrainerConfig(ckpt_dir=str(tmp_path), param_dtype="float16"),
                device="cpu")


class TestTrainerLoop:
    def test_loss_decreases(self, tmp_path):
        tr = make_trainer(tmp_path / "a", ckpt_every=1000, log_every=1)
        tr.train_steps(40)
        losses = [h["loss"] for h in tr.metrics_history]
        assert np.mean(losses[-5:]) < np.mean(losses[:5])

    def test_grad_accum_equivalence(self, tmp_path):
        """accum=2 over the same global batch ≈ accum=1 (same data)."""
        t1 = make_trainer(tmp_path / "g1", ckpt_every=1000, grad_accum=1)
        t2 = make_trainer(tmp_path / "g2", ckpt_every=1000, grad_accum=2)
        for p, q in zip(tree_leaves(t1.params), tree_leaves(t2.params)):
            assert torch.equal(p, q)                # the same seed
        t1.train_steps(3)
        t2.train_steps(3)
        for a, b in zip(tree_leaves(t1.params), tree_leaves(t2.params)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), **PARAM_TOL)

    @pytest.mark.parametrize("quant", [False, True])
    def test_restart_continuation_bit_exact(self, tmp_path, quant):
        """Kill after step 10, restart from the checkpoint, reach step 20
        with the exact params of an uninterrupted run."""
        def trainer(d):
            tr = make_trainer(tmp_path / d, ckpt_every=10)
            if quant:
                tr.opt_cfg = AdamWConfig(quantize_moments=True)
                tr._build()
            return tr
        ref = trainer("ref")
        ref.run(20)
        a = trainer("ab")
        a.train_steps(10)           # checkpoint written at 10
        a.ckpt.wait()
        b = trainer("ab")            # a fresh process
        b.run(20)
        assert b.step == 20
        for x, y in zip(tree_leaves(ref.params), tree_leaves(b.params)):
            assert torch.equal(x, y)
        for x, y in zip(tree_leaves(ref.opt_state), tree_leaves(b.opt_state)):
            assert isinstance(x, QTensor) == isinstance(y, QTensor)
            for u, v in zip(*((x, y) if isinstance(x, QTensor)
                              else ((x,), (y,)))):
                assert torch.equal(u, v)
        assert all(p.requires_grad for p in tree_leaves(b.params))

    def test_peer_failure_triggers_restart(self, tmp_path):
        hb_dir = str(tmp_path / "hb")
        tr = make_trainer(tmp_path / "pf", ckpt_every=5, hb_dir=hb_dir)
        dead = Heartbeat(hb_dir, host_id=7, timeout_s=0.05)
        dead.beat(0)
        tr.hb.timeout_s = 0.05
        time.sleep(0.1)
        with pytest.raises(PeerFailure):
            tr.train_steps(10)
        tr2 = make_trainer(tmp_path / "pf", ckpt_every=5, hb_dir=hb_dir)
        tr2.hb.timeout_s = 1000.0     # peer considered alive again
        tr2.run(12)
        assert tr2.step == 12

    def test_restart_loop_survives_a_failure(self, tmp_path):
        """``run`` catches the PeerFailure a hook raises once, reloads the
        newest checkpoint and finishes."""
        tr = make_trainer(tmp_path / "rl", ckpt_every=2)
        fired = []

        def hook(t):
            if t.step == 5 and not fired:
                fired.append(t.step)
                raise PeerFailure(["host_00003"])
        tr.run(8, failure_hook=hook)
        assert fired == [5] and tr.step == 8

    def test_no_checkpoint_when_ckpt_every_is_zero(self, tmp_path):
        tr = make_trainer(tmp_path / "nc", ckpt_every=0)
        tr.run(3)
        assert tr.step == 3
        assert latest_step(str(tmp_path / "nc")) is None

    @pytest.mark.parametrize("other", ["arch", "data_seed"])
    def test_restore_refuses_another_runs_checkpoint(self, tmp_path, other):
        """A checkpoint of another architecture or data seed in the
        directory raises instead of being resumed."""
        make_trainer(tmp_path / "ck", ckpt_every=2).run(2)
        tr = make_trainer(tmp_path / "ck", ckpt_every=2)
        if other == "arch":
            tr.cfg = dataclasses.replace(TINY, name="tiny-other")
        else:
            tr.data_cfg = dataclasses.replace(DATA, seed=DATA.seed + 1)
        with pytest.raises(ValueError, match=other):
            tr.run(4)
        assert tr.step == 0


class TestMonitors:
    def test_straggler_flags_slow_step(self):
        logs = []
        mon = StragglerMonitor(threshold=2.0, warmup=0,
                               log=lambda m: logs.append(m))
        mon.record(0, 0.1)      # seeds the EWMA
        for i in range(1, 6):
            assert not mon.record(i, 0.1)
        assert mon.record(6, 0.5)          # 5× EWMA → flagged
        assert len(mon.flagged) == 1 and "rebalance" in logs[0]

    def test_straggler_warmup_skipped(self):
        mon = StragglerMonitor(warmup=3, log=lambda m: None)
        assert not mon.record(0, 99.0)
        assert not mon.record(1, 99.0)

    def test_heartbeat_cycle(self, tmp_path):
        clock = {"t": 0.0}
        hb0 = Heartbeat(str(tmp_path), 0, timeout_s=5,
                        clock=lambda: clock["t"])
        hb1 = Heartbeat(str(tmp_path), 1, timeout_s=5,
                        clock=lambda: clock["t"])
        hb0.beat(1)
        hb1.beat(1)
        assert hb0.dead_peers() == []
        clock["t"] = 10.0
        hb0.beat(2)                        # host 0 alive, host 1 stale
        assert hb0.dead_peers() == [1]
        with pytest.raises(PeerFailure):
            hb0.check()

    def test_heartbeat_files_in_the_reference_format(self, tmp_path):
        """The port's heartbeat files and the reference's read each other."""
        Heartbeat(str(tmp_path), 3, clock=lambda: 7.0).beat(11)
        JHeartbeat(str(tmp_path), 4, clock=lambda: 8.0).beat(12)
        want = {3: {"t": 7.0, "step": 11}, 4: {"t": 8.0, "step": 12}}
        assert JHeartbeat(str(tmp_path), 0).peers() == want
        assert Heartbeat(str(tmp_path), 0).peers() == want


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _main(tmp_path, *extra):
    return launch_train.main([
        "--arch", "gemma2-2b", "--smoke", "--device", "cpu",
        "--seq-len", "16", "--global-batch", "4",
        "--ckpt-dir", str(tmp_path / "ck"), *extra])


def test_launch_train_smoke(tmp_path, capsys):
    """The smoke config trains on the CPU (a finite loss every step), the
    final checkpoint is written and a second run resumes from it."""
    assert _main(tmp_path, "--steps", "8", "--warmup", "2", "--log-every",
                 "1", "--grad-accum", "2") == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[trainer] step")]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert out.splitlines()[-1].startswith("final loss")
    assert latest_step(str(tmp_path / "ck")) == 8
    assert _main(tmp_path, "--steps", "9", "--warmup", "2") == 0
    assert "restored step 8" in capsys.readouterr().out


def test_launch_train_quant_moments_and_plain_backend(tmp_path, capsys):
    assert _main(tmp_path, "--steps", "2", "--quant-moments", "--backend",
                 "torch", "--ckpt-every", "0", "--log-every", "1") == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("final loss")


def test_launch_train_default_ckpt_dir_is_per_run(tmp_path, monkeypatch,
                                                  capsys):
    """Without ``--ckpt-dir`` each run writes to a new directory under the
    temporary one, so a second run trains from step 0."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    argv = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--seq-len",
            "8", "--global-batch", "2", "--steps", "1", "--ckpt-every", "1",
            "--log-every", "1"]
    dirs = []
    for _ in range(2):
        trainer, hist = launch_train.train(launch_train.parse_args(argv))
        assert [h["step"] for h in hist] == [1]
        dirs.append(trainer.tc.ckpt_dir)
        assert latest_step(trainer.tc.ckpt_dir) == 1
    assert dirs[0] != dirs[1]
    assert all(d.startswith(str(tmp_path)) for d in dirs)
    assert "restored" not in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--mesh", "single"], ["--compress-pod"]])
def test_launch_train_not_ported_flags(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="A7.7"):
        _main(tmp_path, "--steps", "1", *flags)
