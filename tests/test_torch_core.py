"""The port's core descriptors and launch prologue against the JAX package.

Descriptors (stencil offsets, composition, slot tables) and the neighbour
prologue (``gather_neighbors``, ``halo_extend``) are pure data movement, so
the port must equal the reference **exactly**; the validation errors must
be raised where the reference raises them.  Import hygiene: the port never
imports ``jax`` or ``repro``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as japi
import repro.core.lattice as jlat
import repro.lb.stencil as jst
import repro_torch.core.api as tapi
import repro_torch.core.lattice as tlat
import repro_torch.lb.stencil as tst
from repro_torch.core import (
    Target,
    as_target,
    executor_wants,
    register_executor,
    registry_version,
    unregister_executor,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STENCILS = ("STENCIL_D3Q19_PULL", "STENCIL_GRAD_6PT", "STENCIL_GRAD_19PT")


class TestDescriptors:
    @pytest.mark.parametrize("name", STENCILS)
    def test_stencil_offsets_and_radius(self, name):
        a, b = getattr(tlat, name), getattr(jlat, name)
        assert a.name == b.name
        assert a.offsets == b.offsets
        assert a.radius == b.radius
        assert a.radius_per_dim() == b.radius_per_dim()

    def test_compose_matches(self):
        a = tlat.STENCIL_GRAD_6PT.compose(tlat.STENCIL_D3Q19_PULL, name="x")
        b = jlat.STENCIL_GRAD_6PT.compose(jlat.STENCIL_D3Q19_PULL, name="x")
        assert a.offsets == b.offsets and a.noffsets == 57
        assert tst.STENCIL_FUSED_G.offsets == jst.STENCIL_FUSED_G.offsets
        assert tst.STENCIL_FUSED_G.radius_per_dim() == (2, 2, 2)

    def test_index_matches(self):
        for off in tlat.STENCIL_GRAD_19PT.offsets:
            assert (tlat.STENCIL_GRAD_19PT.index(off)
                    == jlat.STENCIL_GRAD_19PT.index(off))
        with pytest.raises(KeyError):
            tlat.STENCIL_GRAD_6PT.index((2, 0, 0))

    def test_slot_tables_match(self):
        assert tst._PULL_IDX == jst._PULL_IDX
        assert tst._FUSED_G_IDX == jst._FUSED_G_IDX

    def test_stencil_validation(self):
        with pytest.raises(ValueError, match="duplicate"):
            tlat.Stencil("d", ((0, 0), (0, 0)))
        with pytest.raises(ValueError, match="dimensionality"):
            tlat.Stencil("d", ((0, 0), (0, 0, 1)))
        with pytest.raises(ValueError, match="positive"):
            tlat.Lattice((4, 0))


class TestTargetAndRegistry:
    def test_target_validation(self):
        with pytest.raises(ValueError, match="non-empty"):
            Target("")
        with pytest.raises(ValueError, match="vvl"):
            Target("cuda", vvl=0)
        with pytest.raises(ValueError, match="layout"):
            Target("cuda", layout="aos")
        with pytest.raises(TypeError):
            as_target(3)
        assert Target().executor == "cuda"
        assert as_target("torch", vvl=8) == Target("torch", vvl=8)

    def test_register_and_version(self):
        assert executor_wants("torch") == "gathered"
        assert executor_wants("cuda") == "gathered"
        assert executor_wants("cuda_windowed") == "halo_extended"
        v0 = registry_version()
        register_executor("_tmp_exec", tapi.torch_executor)
        try:
            assert registry_version() == v0 + 1
            with pytest.raises(ValueError, match="already registered"):
                register_executor("_tmp_exec", tapi.torch_executor)
        finally:
            unregister_executor("_tmp_exec")
        assert registry_version() == v0 + 2
        with pytest.raises(ValueError, match="capability"):
            register_executor("_bad", tapi.torch_executor, wants="window")
        with pytest.raises(ValueError, match="unknown executor"):
            executor_wants("nope")


def _grid(rng, ncomp, ext):
    return rng.normal(size=(ncomp, int(np.prod(ext)))).astype(np.float32)


class TestPrologue:
    """gather_neighbors / halo_extend equal the reference bit for bit."""

    @pytest.mark.parametrize("shape,halo,stencil", [
        ((5, 4, 3), (0, 0, 0), "STENCIL_D3Q19_PULL"),
        ((6, 5, 4), (1, 0, 0), "STENCIL_D3Q19_PULL"),
        ((6, 5, 4), (2, 1, 0), "STENCIL_GRAD_6PT"),
    ])
    def test_gather_neighbors_exact(self, shape, halo, stencil):
        rng = np.random.default_rng(1)
        ext = tuple(s + 2 * h for s, h in zip(shape, halo))
        x = _grid(rng, 3, ext)
        a = tapi.gather_neighbors(torch.from_numpy(x), shape, halo,
                                  getattr(tlat, stencil))
        b = japi.gather_neighbors(jnp.asarray(x), shape, halo,
                                  getattr(jlat, stencil))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("shape,halo,composed", [
        ((5, 4, 3), (0, 0, 0), False),      # periodic
        ((6, 5, 4), (1, 0, 0), False),      # caller ghosts in x
        ((6, 5, 4), (3, 2, 0), False),      # wider ghosts, trimmed
        ((6, 5, 4), (0, 0, 0), True),       # radius 2, periodic
        ((6, 5, 4), (2, 0, 2), True),       # radius 2, ghosts
    ])
    def test_halo_extend_exact(self, shape, halo, composed):
        rng = np.random.default_rng(2)
        ext = tuple(s + 2 * h for s, h in zip(shape, halo))
        x = _grid(rng, 2, ext)
        sa = tst.STENCIL_FUSED_G if composed else tlat.STENCIL_D3Q19_PULL
        sb = jst.STENCIL_FUSED_G if composed else jlat.STENCIL_D3Q19_PULL
        a = tapi.halo_extend(torch.from_numpy(x), shape, halo, sa)
        b = japi.halo_extend(jnp.asarray(x), shape, halo, sb)
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_halo_extend_thin_dim_refused(self):
        x = np.zeros((1, 4 * 1 * 4), np.float32)
        for mod, lat, st in ((tapi, tlat, tst), (japi, jlat, jst)):
            arr = torch.from_numpy(x) if mod is tapi else jnp.asarray(x)
            with pytest.raises(ValueError, match="exceeds the periodic"):
                mod.halo_extend(arr, (4, 1, 4), (0, 0, 0), st.STENCIL_FUSED_G)

    def test_pad_sites(self):
        x = torch.arange(10, dtype=torch.float32).reshape(2, 5)
        y = tapi.pad_sites(x, 4)
        assert tuple(y.shape) == (2, 8)
        np.testing.assert_array_equal(y.numpy(),
                                      np.asarray(japi.pad_sites(
                                          jnp.asarray(x.numpy()), 4)))


class TestImportHygiene:
    def _files(self):
        return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
                + sorted((ROOT / "tools").glob("*.py"))
                + [ROOT / "chip_smoke.py"])

    def test_no_jax_or_repro_imports(self):
        bad = []
        for path in self._files():
            tree = ast.parse(path.read_text(), filename=str(path))
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    if top in ("jax", "jaxlib", "repro"):
                        bad.append(f"{path.relative_to(ROOT)}: {name}")
        assert not bad, bad

    def test_import_leaves_jax_out(self):
        code = ("import sys, repro_torch.lb.sim, repro_torch.kernels.ops, "
                "repro_torch.kernels.tdp_pointwise, "
                "repro_torch.kernels.tdp_windowed, "
                "repro_torch.kernels.flash_attention, "
                "repro_torch.models.lm, repro_torch.models.params, "
                "repro_torch.runtime.steps, repro_torch.launch.serve, "
                "repro_torch.configs.gemma2_2b, repro_torch.core.autotune, "
                "repro_torch.core.costmodel, repro_torch.kernels.calibrate; "
                "assert 'jax' not in sys.modules, 'jax imported'; "
                "assert 'repro' not in sys.modules, 'repro imported'")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
