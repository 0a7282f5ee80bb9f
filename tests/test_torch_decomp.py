"""The port's domain decompositions (slab, pencil, block, overlap) against the
reference's, on the CPU.

* the pure helpers — ``_exchange_hops``, ``exchange_stats``,
  ``_overlap_regions`` — equal the reference's on the cases of
  ``tests/test_program.py``; ``exchange_ghosts`` with the stacked-shard fake
  permute is bit-equal to the reference's with the same fake and to a
  global roll; every ``ValueError`` the reference's mesh compile raises, the
  port raises;
* gloo lanes (``tests/torch_decomp_lanes.py``, one spawn per mesh shape, 2,
  4 and 8 ranks over a file store) run ``BinaryFluidSim`` under the
  reference's meshes, shapes and seeds (``tests/test_distributed.py``):
  their schedules and ``comm_stats`` are the reference's, the collectives
  counted are ``comm_stats``'s, ``run`` equals ``step`` bit for bit, the
  gathered state equals the port's one-device run and lies within the
  trajectory bar of the reference's single-device ``"xla"`` run, and the
  mesh-reduced observables are the one-device ones.

The gathered state is held to the one-device run at ``rtol=1e-5,
atol=1e-7``, not bit for bit: the plain collision body contracts its
moments with ``torch.einsum`` (a BLAS product on the CPU), whose rounding
depends on the number of sites in the launch, and a decomposed step
launches over blocks and recompute rings of other sizes.  The card's kernels
compute site by site; ``chip_smoke.py`` holds their decomposed runs to the
one-device run bit for bit.
"""
from __future__ import annotations

import dataclasses
import importlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_decomp_lanes as lanes
from repro.lb import params as jparams
from repro.lb import programs as jlbp
from repro.lb import sim as jsim
from repro_torch.lb import programs as tlbp
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim, LBState

jprog = importlib.import_module("repro.core.program")
tprog = importlib.import_module("repro_torch.core.program")

PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
#: the trajectory bar against the reference (ROADMAP, port conventions)
BAR = dict(rtol=2e-4, atol=2e-5)
#: decomposed against one-device on the CPU (see the module docstring)
SPLIT = dict(rtol=1e-5, atol=1e-7)
#: seconds a lane may take, its ranks' start included
LANE_TIMEOUT = 300


# ---------------------------------------------------------------------------
# the pure helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,local", [(2, 8), (8, 8), (3, 2), (5, 2),
                                         (2, 1)])
def test_exchange_hops_are_the_references(width, local):
    got = tprog._exchange_hops(width, local)
    assert got == jprog._exchange_hops(width, local)
    assert sum(t for _, t in got) == width


@pytest.mark.parametrize("widths,ncomp,local,shard_dims", [
    ({"f": (1, 1, 0), "g": (2, 2, 0)}, {"f": 19, "g": 19}, (8, 8, 16),
     (0, 1)),
    ({"g": (2,)}, {"g": 1}, (1,), (0,)),
    ({"f": (1, 1, 1), "g": (2, 2, 2)}, {"f": 19, "g": 19}, (8, 8, 8),
     (0, 1, 2)),
    ({"f": (1, 1, 0), "g": (2, 2, 0)}, {"f": 19, "g": None}, (4, 1, 8),
     (0, 1)),
    ({"f": (0, 0, 0), "g": (1, 1, 0)}, {"f": 19, "g": 19}, (8, 8, 16),
     (0, 1)),
], ids=["pencil", "thin-1d", "block", "thin-pencil", "collide-prologue"])
def test_exchange_stats_are_the_references(widths, ncomp, local,
                                           shard_dims):
    got = tprog.exchange_stats(widths, ncomp, local, shard_dims)
    assert got == jprog.exchange_stats(widths, ncomp, local, shard_dims)


@pytest.mark.parametrize("local,W,shard_dims", [
    ((8, 8, 16), (1, 1, 0), (0, 1)),
    ((8, 8, 16), (2, 2, 0), (0, 1)),
    ((4, 4, 4), (1, 1, 1), (0, 1, 2)),
    ((8, 4, 8), (2, 0, 0), (0, 1)),
    ((6, 8), (2, 1), (0, 1)),
])
def test_overlap_regions_are_the_references(local, W, shard_dims):
    got = tprog._overlap_regions(local, W, shard_dims)
    assert got == jprog._overlap_regions(local, W, shard_dims)
    (i_start, i_shape), bounds = got
    cover = np.zeros(local, np.int32)
    for start, shape in [(i_start, i_shape)] + [r for _, lo, hi in bounds
                                                for r in (lo, hi)]:
        cover[tuple(slice(s, s + n) for s, n in zip(start, shape))] += 1
    assert (cover == 1).all()


def _stacked_permute(index):
    """The reference tests' stacked-shard fake: ``ppermute``'s ``(src,
    dst)`` pairs as a reindexing of the leading rank axis."""
    def permute(x, pairs):
        idx = np.zeros(x.shape[0], int)
        for src, dst in pairs:
            idx[dst] = src
        return index(x, idx)
    return permute


@pytest.mark.parametrize("nranks,loc,width,dim", [
    (2, 4, 1, 0), (2, 4, 3, 0), (4, 2, 2, 0),
    (4, 1, 2, 0),           # thin pencil: 2 hops
    (3, 2, 5, 0),           # width > 2 shards: 3 hops
    (8, 1, 4, 0),           # maximal decomposition
    (4, 2, 3, 1),           # an exchanged dim other than 0, 2 hops
])
def test_exchange_ghosts_matches_the_reference_and_a_roll(nranks, loc, width,
                                                         dim):
    rng = np.random.default_rng(nranks * 100 + loc * 10 + width)
    glob = rng.normal(size=(1, 3, nranks * loc) if dim
                      else (2, nranks * loc)).astype(np.float32)
    shards = np.stack([glob[..., i * loc:(i + 1) * loc]
                       for i in range(nranks)])
    # the stacked shards carry the rank axis first: grid dim d is axis d+2
    got = tprog.exchange_ghosts(
        torch.from_numpy(shards), dim + 1, width, nranks,
        _stacked_permute(lambda x, i: x[torch.as_tensor(i)]))
    want = jprog.exchange_ghosts(
        jnp.asarray(shards), dim + 1, width, nranks,
        _stacked_permute(lambda x, i: x[jnp.asarray(i)]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(nranks):
        cols = np.arange(i * loc - width, (i + 1) * loc + width) % (
            nranks * loc)
        np.testing.assert_array_equal(got[i].numpy(), glob[..., cols])


class _Mesh:
    """A mesh for the compile-time checks: only its axis sizes are read."""

    def __init__(self, **sizes):
        self.shape = sizes


#: (grid, mesh axes, shard_axis, message) of every ValueError the
#: reference's mesh compile raises (tests/test_program.py)
ERRORS = [
    ((2, 8, 8), {"data": 2}, "data", "ghost exchange"),
    ((8, 9, 8), {"px": 2, "py": 2}, ("px", "py"),
     r"Y extent 9 not divisible by mesh axis py=2"),
    ((8, 8, 8), {"px": 2, "py": 2}, ("px", "pz"), "not a mesh axis"),
    ((8, 8, 8), {"px": 2, "py": 2}, ("px", "px"), "duplicate shard axes"),
    ((8, 8), {"px": 2, "py": 2}, ("px", "py", "px2"), "at most 2"),
    ((8, 2, 8), {"px": 2, "py": 2}, ("px", "py"), "ghost exchange in dim 1"),
    ((8, 8, 1), {"data": 2}, "data", r"unsharded \(periodic\) extent 1"),
    ((8, 8, 1), None, None, "shard dim 2 with a mesh"),
    ((8, 8, 8), {"data": 2}, (), "shard_axis is empty"),
]


@pytest.mark.parametrize("grid,sizes,shard_axis,match", ERRORS,
                         ids=[m.split()[0].strip("r\\(") + f"-{i}"
                              for i, (*_, m) in enumerate(ERRORS)])
def test_every_reference_value_error(grid, sizes, shard_axis, match):
    mesh = None if sizes is None else _Mesh(**sizes)
    jconsts = jlbp.collision_consts(**dataclasses.asdict(
        jparams.LBParams(**PARAMS)))
    with pytest.raises(ValueError, match=match):
        jlbp.fused_program("one_launch", jconsts).compile(
            "xla", grid_shape=grid, mesh=mesh, shard_axis=shard_axis)
    tconsts = tlbp.collision_consts(**LBParams(**PARAMS).as_kwargs())
    with pytest.raises(ValueError, match=match):
        tlbp.fused_program("one_launch", tconsts).compile(
            "torch", grid_shape=grid, mesh=mesh, shard_axis=shard_axis)


class _CardMesh(_Mesh):
    """A one-rank mesh that says it is on the card."""
    device_type = "cuda"


def test_a_mesh_on_another_device_raises():
    """Fields are never staged through another device for an exchange: a
    card mesh with CPU fields refuses before any collective."""
    consts = tlbp.collision_consts(**LBParams(**PARAMS).as_kwargs())
    exe = tlbp.fused_program("one_launch", consts).compile(
        "torch", grid_shape=(8, 8, 8), mesh=_CardMesh(data=1),
        shard_axis="data")
    state = BinaryFluidSim((8, 8, 8), LBParams(**PARAMS),
                           device="cpu").init_spinodal(seed=0)
    before = dict(tprog.collectives)
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        exe.step({"f": state.f, "g": state.g})
    assert tprog.collectives == before
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        BinaryFluidSim((8, 8, 8), LBParams(**PARAMS), device="cpu",
                       mesh=_CardMesh(data=1), shard_axis="data")


# ---------------------------------------------------------------------------
# the gloo lanes
# ---------------------------------------------------------------------------

def _spawn(name: str, tmp) -> dict:
    shape = lanes.LANES[name][0]
    world = int(np.prod(shape))
    ctx = mp.start_processes(lanes.lane, args=(world, str(tmp), name),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + LANE_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"lane {name} ran past {LANE_TIMEOUT} s")
    assert all(not p.is_alive() for p in ctx.processes)
    return torch.load(tmp / "result.pt", weights_only=False)


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """``lane(name)``: the lane's saved results, spawned once per module."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _spawn(name, tmp_path_factory.mktemp(name))
        return done[name]
    return get


@pytest.fixture(scope="module")
def one_device():
    """``(port state, reference state)`` of a case on one device."""
    done = {}

    def get(case):
        if case not in done:
            grid, fused, seed, steps, _ = lanes.CASES[case]
            sim = BinaryFluidSim(grid, LBParams(**PARAMS), device="cpu",
                                 fused=fused)
            own = sim.step(sim.init_spinodal(seed=seed), steps)
            jsm = jsim.BinaryFluidSim(grid, params=jparams.LBParams(**PARAMS),
                                      fused=fused)
            ref = jsm.step(jsm.init_spinodal(seed=seed), steps)
            done[case] = (own, (np.asarray(ref.f), np.asarray(ref.g)))
        return done[case]
    return get


CASES = [(name, case) for name, (_, _, cases) in lanes.LANES.items()
         for case in cases]
CASE_IDS = [f"{name}-{case}" for name, case in CASES]


@pytest.mark.parametrize("name,case", CASES, ids=CASE_IDS)
def test_gathered_state_matches_one_device(lane, one_device, name, case):
    got = lane(name)[case]
    own, _ = one_device(case)
    for fld in ("f", "g"):
        torch.testing.assert_close(got[fld], getattr(own, fld), **SPLIT)


@pytest.mark.parametrize("name,case", CASES, ids=CASE_IDS)
def test_state_within_the_bar_of_the_reference(lane, one_device, name, case):
    got = lane(name)[case]
    _, (jf, jg) = one_device(case)
    np.testing.assert_allclose(got["f"].numpy(), jf, **BAR)
    np.testing.assert_allclose(got["g"].numpy(), jg, **BAR)


@pytest.mark.parametrize("name,case", CASES, ids=CASE_IDS)
def test_observables_are_the_one_device_ones(lane, name, case):
    """The mesh-reduced observables against the one-device formulas on the
    gathered state: minima, maxima and the NaN flag exactly; the float64
    sums and the variance (about the global mean) to 1e-12, the order in
    which the ranks' partial sums add up."""
    got = lane(name)[case]
    grid, fused, *_ = lanes.CASES[case]
    want = BinaryFluidSim(grid, LBParams(**PARAMS), device="cpu",
                          fused=fused).observables(
        LBState(got["f"], got["g"]))
    obs = got["observables"]
    assert set(obs) == set(want)
    for k in ("phi_min", "phi_max", "rho_min", "nan"):
        assert obs[k] == want[k], k
    for k in ("mass", "phi_total", "phi_var"):
        assert obs[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("name,case", CASES, ids=CASE_IDS)
def test_collectives_are_comm_stats(lane, name, case):
    """Every collective of a step is counted where it is posted, and a step
    posts ``comm_stats()["ppermutes_per_step"]`` of them; ``run`` (the
    ping-pong buffers) equals ``step`` bit for bit on every rank."""
    got = lane(name)[case]
    assert got["collectives"] == got["expected_collectives"] > 0
    assert got["run_equals_step"]


def _reference_stats(case, shard_dims, local):
    """The reference's schedule and ``exchange_stats`` for a case's
    programs under its open dims (pure Python on the reference side)."""
    _, fused, *_ = lanes.CASES[case]
    consts = jlbp.collision_consts(**dataclasses.asdict(
        jparams.LBParams(**PARAMS)))
    progs = ({"collide": jlbp.collide_program(consts),
              "fused": jlbp.fused_program(fused, consts),
              "stream": jlbp.stream_program()} if fused
             else {"step": jlbp.unfused_step_program(consts)})
    open_mask = tuple(d in shard_dims for d in range(3))
    out = {}
    for k, p in progs.items():
        widths, _ = p.schedule(3, open_mask)
        out[k] = jprog.exchange_stats(widths, p.ncomp, local, shard_dims)
    return out


@pytest.mark.parametrize("name,case", CASES, ids=CASE_IDS)
def test_comm_stats_are_the_references(lane, name, case):
    got = lane(name)[case]
    shape = lanes.LANES[name][0]
    shard_dims = tuple(range(len(shape)))
    want = _reference_stats(case, shard_dims, got["local_shape"])
    kinds = {1: "slab", 2: "pencil", 3: "block"}
    for k, ref in want.items():
        cs = got["programs"][k]["comm_stats"]
        for key in ("per_field", "exchanged_bytes_per_step",
                    "ppermutes_per_step"):
            assert cs[key] == ref[key], (k, key)
        assert cs["decomposition"] == kinds[len(shape)]
        assert cs["mesh_axis_sizes"] == shape
        assert cs["local_shape"] == got["local_shape"]


def test_slab_schedules(lane):
    """The reference's literal slab schedules: f travels one plane in the
    two-launch step, the collide prologue exchanges no f at all."""
    progs = lane("slab4")["two_launch_16x8x8"]["programs"]
    assert progs["fused"]["halo_schedule"] == {"f": 1, "g": 2}
    assert progs["collide"]["halo_schedule"] == {"f": 0, "g": 1}
    assert progs["stream"]["halo_schedule"] == {"f": 1, "g": 1}
    one = lane("slab4")["unfused_4x8x8"]
    assert one["local_shape"] == (1, 8, 8)
    # g's width 2 over 1-plane shards: two hops each way
    assert one["programs"]["step"]["comm_stats"]["per_field"]["g"][
        "ppermutes"] == 4
    two = lane("slab2")["unfused_4x8x8"]
    assert two["programs"]["step"]["comm_stats"]["per_field"]["g"][
        "ppermutes"] == 2


def test_pencil_schedules_and_overlap(lane):
    got = lane("pencil")
    progs = got["two_launch_16cubed"]["programs"]
    assert progs["fused"]["exchange_schedule"] == {"f": {0: 1, 1: 1},
                                                   "g": {0: 2, 1: 2}}
    assert progs["fused"]["halo_schedule"] == {"f": 1, "g": 2}
    assert progs["collide"]["exchange_schedule"] == {"f": {},
                                                     "g": {0: 1, 1: 1}}
    cs = progs["fused"]["comm_stats"]
    assert cs["decomposition"] == "pencil" and cs["mesh_axis_sizes"] == (2, 2)
    assert cs["local_shape"] == (8, 8, 16)
    assert cs["ppermutes_per_step"] == 8 and cs["exchanged_bytes_per_step"] > 0
    assert progs["fused"]["overlap"] is False     # the default stays unsplit
    ov = got["two_launch_16cubed_overlap"]["programs"]["fused"]
    assert ov["overlap"] is True and ov["comm_stats"]["overlap"] is True
    # interior (8 - 2·2)² · 16 of 8 · 8 · 16 local sites
    assert abs(ov["comm_stats"]["interior_fraction"] - 16.0 / 64.0) < 1e-12


def test_block_and_thin_pencil_schedules(lane):
    cs = lane("block")["two_launch_16cubed_5"]["programs"]["fused"][
        "comm_stats"]
    assert cs["decomposition"] == "block" and cs["local_shape"] == (8, 8, 8)
    thin = lane("thin")["two_launch_8x4x8"]
    assert thin["local_shape"] == (4, 1, 8)
    # 2 (dim 0) + 4 (dim 1: two hops each way)
    assert thin["programs"]["fused"]["comm_stats"]["per_field"]["g"][
        "ppermutes"] == 6


@pytest.mark.parametrize("exchange", lanes.EXCHANGES,
                         ids=lambda e: "n{}-loc{}-w{}".format(*e))
def test_exchange_dim_over_gloo_is_a_roll(lane, exchange):
    """``_exchange_dim`` through real collectives on 4 ranks (single and
    multi-hop) fills each shard as the wrap-indexed global array does."""
    assert lane("slab4")["exchange_dim"][exchange]


def test_spinodal_example_under_a_pencil(lane):
    """``lb_spinodal --mesh 2x2`` on the 4-rank gloo group: the comm line's
    stats, mass conserved, the domains grow."""
    r = lane("pencil")["example"]
    assert r["comm_stats"]["decomposition"] == "pencil"
    assert r["comm_stats"]["ppermutes_per_step"] == 8   # unfused: f 4, g 4
    assert r["mass_drift"] <= 1e-5
    assert r["last"]["phi_var"] > r["first"]["phi_var"]
