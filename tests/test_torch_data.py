"""The port's synthetic data pipeline against the JAX package's.

``batch_for_step`` equals the reference's (same numpy generator, same
seed): tokens, labels and the successor table, for whole batches and row
slices.  The loader puts them on the trainer's device as int64.  Then the
reference's own data tests (``tests/test_data.py``) on the port.
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import SyntheticConfig, batch_for_step, make_batch_loader
from repro_torch.data.synthetic import _successor_table

CFG = SyntheticConfig(vocab_size=100, seq_len=64, global_batch=8, seed=11)

#: (vocab, seq_len, global_batch, seed, branching)
CASES = [(100, 64, 8, 11, 8), (512, 16, 4, 0, 8), (64, 16, 4, 1, 8),
         (256_000, 32, 2, 3, 8), (50, 7, 3, 5, 2)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("step", [0, 7])
def test_batch_equals_reference(case, step):
    v, s, b, seed, br = case
    cfg = SyntheticConfig(v, s, b, seed=seed, branching=br)
    jcfg = jsyn.SyntheticConfig(v, s, b, seed=seed, branching=br)
    got, want = batch_for_step(cfg, step), jsyn.batch_for_step(jcfg, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(_successor_table(cfg),
                                  jsyn._successor_table(jcfg))


@pytest.mark.parametrize("lo,hi", [(0, 2), (3, 7), (6, 8)])
def test_row_slices_equal_reference(lo, hi):
    jcfg = jsyn.SyntheticConfig(100, 64, 8, seed=11)
    got = batch_for_step(CFG, 9, lo=lo, hi=hi)
    want = jsyn.batch_for_step(jcfg, 9, lo=lo, hi=hi)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("pi", [0, 1])
def test_loader_int64_on_device(pi):
    load = make_batch_loader(CFG, device="cpu", process_index=pi,
                             process_count=2)
    b = load(4)
    full = batch_for_step(CFG, 4)
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int64 and b[k].device.type == "cpu"
        np.testing.assert_array_equal(b[k].numpy(),
                                      full[k][4 * pi:4 * (pi + 1)])


def test_loader_defaults_to_the_card():
    """With no device the loader puts batches on the card, and raises
    where there is none."""
    if torch.cuda.is_available():
        assert make_batch_loader(CFG)(0)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_batch_loader(CFG)


class TestDeterminism:
    def test_same_step_same_batch(self):
        a = batch_for_step(CFG, 5)
        b = batch_for_step(CFG, 5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_different_steps_differ(self):
        a = batch_for_step(CFG, 5)
        b = batch_for_step(CFG, 6)
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_rows_owned_by_position(self):
        full = batch_for_step(CFG, 9)
        for lo, hi in ((0, 2), (3, 7), (6, 8)):
            part = batch_for_step(CFG, 9, lo=lo, hi=hi)
            np.testing.assert_array_equal(full["tokens"][lo:hi],
                                          part["tokens"])

    def test_labels_are_next_tokens(self):
        b = batch_for_step(CFG, 0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


class TestLearnability:
    def test_bigram_structure(self):
        """Every transition obeys the seed's successor table."""
        table = _successor_table(CFG)
        b = batch_for_step(CFG, 3)
        seq = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
        for row in seq[:4]:
            for t in range(len(row) - 1):
                assert row[t + 1] in table[row[t]]

    def test_token_range(self):
        b = batch_for_step(CFG, 2)
        assert b["tokens"].min() >= 0
        assert b["tokens"].max() < CFG.vocab_size
