"""The port's LM example drivers on the CPU: ``train_lm`` on a reduced
preset patched into its table, then ``serve_lm`` from its checkpoint.

The loss falls over the run (``train_lm``'s own check, which the
reference asserts); ``serve_lm`` reports the restore and scores every
generated token against the bigram table; without a checkpoint it serves
random weights and says so.
"""
import pytest

from repro_torch.examples import serve_lm, train_lm

TINY = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, vocab=256, seq=32,
            batch=8)


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(train_lm.PRESETS, "tiny", TINY)


def test_train_then_serve_from_the_checkpoint(tiny_preset, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    trainer, hist = train_lm.run(train_lm.parse_args(
        ["--preset", "tiny", "--steps", "60", "--lr", "3e-3", "--device",
         "cpu", "--ckpt-dir", ckpt]))
    assert [h["step"] for h in hist] == [10, 20, 30, 40, 50, 60]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert trainer.step == 60
    out = capsys.readouterr().out
    assert "[train_lm] lm-tiny:" in out and "loss curve" in out

    res = serve_lm.run(serve_lm.parse_args(
        ["--preset", "tiny", "--device", "cpu", "--ckpt-dir", ckpt,
         "--batch", "4", "--prompt-len", "16", "--gen", "8"]))
    out = capsys.readouterr().out
    assert "[serve_lm] restored trained weights (step 60)" in out
    assert res["trained"] and res["step"] == 60
    assert res["total"] == 4 * 8 and 0 <= res["ok"] <= res["total"]
    assert res["chance"] == 8 / TINY["vocab"]
    assert "continuations following the bigram table" in out


def test_serve_without_a_checkpoint_uses_random_weights(tiny_preset,
                                                        tmp_path, capsys):
    res = serve_lm.run(serve_lm.parse_args(
        ["--preset", "tiny", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "none"), "--batch", "2", "--prompt-len", "8",
         "--gen", "4"]))
    assert not res["trained"] and res["total"] == 8
    assert "(random weights)" in capsys.readouterr().out


def test_examples_default_to_the_card(tiny_preset, tmp_path, monkeypatch):
    """With no ``--device`` both drivers mean the card, and raise without
    one instead of running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.run(serve_lm.parse_args(
            ["--preset", "tiny", "--ckpt-dir", str(tmp_path)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.run(train_lm.parse_args(
            ["--preset", "tiny", "--steps", "1", "--ckpt-dir",
             str(tmp_path)]))
