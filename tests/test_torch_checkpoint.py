"""The port's checkpoint store (``repro_torch.checkpoint``) against the JAX
package's.

Counterparts of ``tests/test_checkpoint.py`` (round trips, python leaves,
fault tolerance, the elastic path) plus the format itself: a checkpoint
written by ``repro.checkpoint.save_checkpoint`` restores through the port
and one written by the port restores through ``repro``, a ``FleetDriver``
snapshot tree included, and the two packages write the same manifest.
Leaves come back bit for bit.
"""
import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import tdp as jtdp
from repro_torch import tdp
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.checkpoint import store as tstore

CPU = "cpu"


@pytest.fixture
def tree():
    rng = np.random.default_rng(1)
    return {
        "params": {"w": torch.tensor(rng.normal(size=(64, 32)),
                                     dtype=torch.float32),
                   "stack": torch.tensor(rng.normal(size=(8, 16, 16)),
                                         dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return tstore._tree_paths(tree)[1]


def _same(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                       else a, b.view(torch.uint8)
                       if b.dtype == torch.bfloat16 else b)


QState = collections.namedtuple("QState", ["codes", "scale"])


class TestRoundtrip:
    def test_basic(self, tmp_path, tree):
        save_checkpoint(str(tmp_path), 7, tree, extra={"foo": "bar"})
        got, extra, step = restore_checkpoint(str(tmp_path), tree,
                                              verify=True, device=CPU)
        assert step == 7 and extra["foo"] == "bar"
        for a, b in zip(_leaves(got), _leaves(tree)):
            _same(a, b)

    def test_named_tuple_leaves_roundtrip(self, tmp_path):
        """A named tuple (the reference's QTensor moments) keeps its
        structure and its ``.field`` keys."""
        st = {"m": {"w": QState(torch.arange(12, dtype=torch.int8),
                                torch.ones(3))}}
        save_checkpoint(str(tmp_path), 1, st)
        man = tstore._load_manifest(tstore._step_dir(str(tmp_path), 1))
        assert [e["key"] for e in man["leaves"]] == ["m/w/.codes",
                                                     "m/w/.scale"]
        got, _, _ = restore_checkpoint(str(tmp_path), st, device=CPU)
        assert isinstance(got["m"]["w"], QState)
        _same(got["m"]["w"].codes, st["m"]["w"].codes)

    def test_sharded_files_concatenate(self, tmp_path):
        rng = np.random.default_rng(2)
        big = {"x": torch.tensor(rng.normal(size=(1024, 512)),
                                 dtype=torch.float32)}
        d = save_checkpoint(str(tmp_path), 3, big, nshards=4)
        files = [f for f in os.listdir(d) if f.endswith(".npy")]
        assert len(files) == 4
        got, _, _ = restore_checkpoint(str(tmp_path), big, device=CPU)
        _same(got["x"], big["x"])


class TestPythonLeaves:
    def test_python_scalar_and_str_leaves_roundtrip(self, tmp_path):
        tree = {"step": 17, "bucket": "lb_step@8x8x8#0", "resumable": True,
                "lr": 2.5e-4, "x": torch.arange(3.0),
                "rng": np.array([0, 7], np.uint32)}
        save_checkpoint(str(tmp_path), 1, tree)
        like = {"step": 0, "bucket": "", "resumable": False, "lr": 0.0,
                "x": 0.0, "rng": 0}
        got, _, _ = restore_checkpoint(str(tmp_path), like, verify=True,
                                       device=CPU)
        assert got["step"] == 17 and type(got["step"]) is int
        assert got["bucket"] == "lb_step@8x8x8#0" and \
            type(got["bucket"]) is str
        assert got["resumable"] is True
        assert got["lr"] == 2.5e-4 and type(got["lr"]) is float
        _same(got["x"], torch.arange(3.0))
        assert got["rng"].tolist() == [0, 7]

    def test_verify_tolerates_py_entries(self, tmp_path):
        save_checkpoint(str(tmp_path), 2, {"tag": "abc", "n": 3})
        assert verify_checkpoint(os.path.join(str(tmp_path),
                                              "step_000000000002"))

    def test_manager_preserves_py_leaves(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(4, {"step": 4, "w": torch.ones(2)}, blocking=True)
        got, _, _ = mgr.restore_latest({"step": 0, "w": 0.0}, device=CPU)
        assert got["step"] == 4 and type(got["step"]) is int

    def test_midflight_program_state_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        state = tdp.ProgramState({
            f: torch.tensor(rng.normal(size=(19, 4, 4, 4)),
                            dtype=torch.float32) for f in ("f", "g")})
        tree = {"state": state, "step": 12, "bucket": "lb@4x4x4#0",
                "rng": np.array([0, 3], np.uint32)}
        save_checkpoint(str(tmp_path), 12, tree)
        like = {"state": tdp.ProgramState({"f": 0.0, "g": 0.0}),
                "step": 0, "bucket": "", "rng": 0}
        got, _, _ = restore_checkpoint(str(tmp_path), like, verify=True,
                                       device=CPU)
        assert isinstance(got["state"], tdp.ProgramState)
        assert got["state"].fields == ("f", "g")
        for f in ("f", "g"):
            _same(got["state"][f], state[f])
        assert got["step"] == 12 and got["bucket"] == "lb@4x4x4#0"


class TestFaultTolerance:
    def test_atomic_no_partial_visible(self, tmp_path, tree):
        save_checkpoint(str(tmp_path), 5, tree)
        os.makedirs(os.path.join(str(tmp_path), "step_000000000009.tmp"))
        assert latest_step(str(tmp_path)) == 5

    def test_corruption_detected(self, tmp_path, tree):
        d = save_checkpoint(str(tmp_path), 5, tree)
        assert verify_checkpoint(d)
        npy = [f for f in os.listdir(d) if f.endswith(".npy")][0]
        with open(os.path.join(d, npy), "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad")
        assert not verify_checkpoint(d)
        with pytest.raises(IOError):
            restore_checkpoint(str(tmp_path), tree, verify=True, device=CPU)

    def test_missing_leaf_detected(self, tmp_path, tree):
        save_checkpoint(str(tmp_path), 5, tree)
        bigger = dict(tree)
        bigger["new_leaf"] = torch.zeros(3)
        with pytest.raises(KeyError):
            restore_checkpoint(str(tmp_path), bigger, device=CPU)

    def test_retention_and_latest(self, tmp_path, tree):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree, blocking=True)
        steps = sorted(int(d[5:]) for d in os.listdir(str(tmp_path))
                       if d.startswith("step_"))
        assert steps == [3, 4]
        assert latest_step(str(tmp_path)) == 4

    def test_async_save_overlaps(self, tmp_path, tree):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, tree)          # background thread
        mgr.save(2, tree)          # joins the previous save first
        mgr.wait()
        assert latest_step(str(tmp_path)) == 2
        assert verify_checkpoint(os.path.join(str(tmp_path),
                                              "step_000000000002"))

    def test_async_save_snapshots_before_returning(self, tmp_path):
        """A CPU tensor written in place right after ``save`` returns does
        not reach the file: the snapshot is a copy."""
        x = torch.zeros(8)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": x})
        x.fill_(5.0)
        mgr.wait()
        got, _, _ = restore_checkpoint(str(tmp_path), {"x": 0.0},
                                       device=CPU)
        assert torch.equal(got["x"], torch.zeros(8))

    def test_background_failure_reraises_on_wait(self, tmp_path):
        root = tmp_path / "ck"
        mgr = CheckpointManager(str(root))
        os.rmdir(root)
        root.write_text("not a directory")   # the writer thread cannot save
        mgr.save(1, {"x": torch.ones(2)})
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()                     # surfaced once


class TestElasticRestore:
    def test_restore_onto_a_device(self, tmp_path, tree):
        """The placement decision is restore-time: leaves land on
        ``device``; ``device=None`` means the card."""
        save_checkpoint(str(tmp_path), 1, tree)
        got, _, _ = restore_checkpoint(str(tmp_path), tree, device=CPU)
        assert got["params"]["w"].device.type == "cpu"
        _same(got["params"]["w"], tree["params"]["w"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                restore_checkpoint(str(tmp_path), tree)

    def test_sharded_restore_names_the_roadmap_item(self, tmp_path, tree):
        save_checkpoint(str(tmp_path), 1, tree)
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            restore_checkpoint(str(tmp_path), tree, shardings=tree,
                               device=CPU)


# ---------------------------------------------------------------------------
# the format, across the two packages
# ---------------------------------------------------------------------------

def _mixed_tree(rng):
    """The same tree for both packages: float32, bfloat16, int32, a uint32
    key, a ProgramState, python leaves and a list."""
    w = rng.normal(size=(40, 7)).astype(np.float32)
    bf = rng.normal(size=(6, 5)).astype(np.float32)
    f = rng.normal(size=(19, 3, 3, 3)).astype(np.float32)
    key = np.array([0, 42], np.uint32)
    j = {"w": jnp.asarray(w), "bf": jnp.asarray(bf, jnp.bfloat16),
         "step": jnp.asarray(7, jnp.int32), "key": jnp.asarray(key),
         "state": jtdp.ProgramState({"f": jnp.asarray(f),
                                     "g": jnp.asarray(2 * f)}),
         "meta": {"bucket": "b#0", "n": 3, "ok": True, "lr": 0.5},
         "seq": [jnp.asarray(w[0]), jnp.asarray(w[1])]}
    t = {"w": torch.tensor(w), "bf": torch.tensor(bf).to(torch.bfloat16),
         "step": torch.tensor(7, dtype=torch.int32),
         "key": torch.from_numpy(key),
         "state": tdp.ProgramState({"f": torch.tensor(f),
                                    "g": torch.tensor(2 * f)}),
         "meta": {"bucket": "b#0", "n": 3, "ok": True, "lr": 0.5},
         "seq": [torch.tensor(w[0]), torch.tensor(w[1])]}
    return j, t


def _flat_np(tree_leaves):
    out = []
    for x in tree_leaves:
        if isinstance(x, (str, bool, int, float)):
            out.append(x)
        elif isinstance(x, torch.Tensor):
            out.append(x.float().numpy() if x.dtype == torch.bfloat16
                       else x.numpy())
        else:
            out.append(np.asarray(x, np.float32)
                       if x.dtype == jnp.bfloat16 else np.asarray(x))
    return out


class TestAcrossPackages:
    def test_same_keys_and_manifest_entries(self, tmp_path):
        jtree, ttree = _mixed_tree(np.random.default_rng(5))
        jck.save_checkpoint(str(tmp_path / "j"), 3, jtree)
        save_checkpoint(str(tmp_path / "t"), 3, ttree)
        jm = tstore._load_manifest(tstore._step_dir(str(tmp_path / "j"), 3))
        tm = tstore._load_manifest(tstore._step_dir(str(tmp_path / "t"), 3))
        assert jm["version"] == tm["version"] == 1
        strip = [{k: v for k, v in e.items() if k != "files"}
                 for e in jm["leaves"]]
        assert strip == [{k: v for k, v in e.items() if k != "files"}
                         for e in tm["leaves"]]
        # the array files are the same bytes, so the same sha256
        assert [[f["sha256"] for f in e["files"]] for e in jm["leaves"]] \
            == [[f["sha256"] for f in e["files"]] for e in tm["leaves"]]

    def test_reference_checkpoint_restores_through_the_port(self, tmp_path):
        jtree, ttree = _mixed_tree(np.random.default_rng(5))
        jck.save_checkpoint(str(tmp_path), 5, jtree, extra={"k": 1})
        like = {"w": 0, "bf": 0, "step": 0, "key": 0,
                "state": tdp.ProgramState({"f": 0, "g": 0}),
                "meta": {"bucket": "", "n": 0, "ok": False, "lr": 0.0},
                "seq": [0, 0]}
        got, extra, step = restore_checkpoint(str(tmp_path), like,
                                              device=CPU)
        assert (extra, step) == ({"k": 1}, 5)
        assert got["bf"].dtype == torch.bfloat16
        assert isinstance(got["state"], tdp.ProgramState)
        for a, b in zip(_flat_np(_leaves(got)), _flat_np(_leaves(ttree))):
            np.testing.assert_array_equal(a, b)

    def test_port_checkpoint_restores_through_the_reference(self, tmp_path):
        jtree, ttree = _mixed_tree(np.random.default_rng(5))
        save_checkpoint(str(tmp_path), 6, ttree, extra={"k": 2})
        got, extra, step = jck.restore_checkpoint(str(tmp_path), jtree)
        assert (extra, step) == ({"k": 2}, 6)
        assert got["bf"].dtype == jnp.bfloat16
        jl = jax.tree_util.tree_leaves(got)
        for a, b in zip(_flat_np(jl), _flat_np(_leaves(ttree))):
            np.testing.assert_array_equal(a, b)

    def test_fleet_snapshot_tree_both_ways(self, tmp_path):
        """A ``FleetDriver`` snapshot of either package restores as the
        other's ``FleetDriver``: ids, steps, sweep values and the member
        states bit for bit."""
        from torch_fleet_common import (jmake_prog, jmembers, make_prog,
                                        members)
        taus = np.array([0.7, 1.1], np.float32)
        jck_dir, tck_dir = str(tmp_path / "j"), str(tmp_path / "t")
        jdrv = jtdp.FleetDriver("xla", batch=2, checkpoint_dir=jck_dir)
        jprog = jmake_prog(jtdp.TargetConst(np.float32(1.0)))
        for i, m in enumerate(jmembers(2)):
            jdrv.submit(jprog, {"state": m, "consts": {"tau": taus[i]},
                                "rng": np.array([0, i], np.uint32)}, 5)
        jdrv.pump(2)
        jdrv.checkpoint()
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        drv = tdp.FleetDriver.restore(jck_dir, prog, device=CPU,
                                      target="torch")
        for tid, jt in jdrv._tickets.items():
            t = drv._tickets[tid]
            assert (t.step, t.nsteps, float(t.consts["tau"])) == \
                (jt.step, jt.nsteps, float(jt.consts["tau"]))
            assert t.rng.tolist() == np.asarray(jt.rng).tolist()
            np.testing.assert_array_equal(t._state["a"].numpy(),
                                          np.asarray(jt._state["a"]))
        # and back: the port's snapshot through the reference
        tdrv = tdp.FleetDriver("torch", batch=2, checkpoint_dir=tck_dir)
        for i, m in enumerate(members(2)):
            tdrv.submit(prog, {"state": m, "consts": {"tau": taus[i]}}, 5)
        tdrv.pump(3)
        tdrv.checkpoint()
        jdrv2 = jtdp.FleetDriver.restore(tck_dir, jprog)
        for tid, t in tdrv._tickets.items():
            jt = jdrv2._tickets[tid]
            assert (jt.step, jt.nsteps) == (t.step, t.nsteps) == (3, 5)
            np.testing.assert_array_equal(np.asarray(jt._state["a"]),
                                          t._state["a"].numpy())
        man = json.load(open(os.path.join(tstore._step_dir(
            tck_dir, 3), "manifest.json")))
        assert man["extra"]["batch"] == 2
