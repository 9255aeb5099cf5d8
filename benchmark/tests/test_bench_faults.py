"""A run whose timed path is broken comes out not correct.

Each case drives the whole harness on a tiny cell on the CPU (the look
for a card skipped) with the program's step broken underneath: the step
returns its state unchanged; half of the channels are left out of the
packed buffer (every other one, so that any sample of a few rows
holds some); a bit of every frame is altered where the buffer is
produced. The cells run on one chip, so no exchange between chips can be
left out."""

import pytest
import torch

from benchmark.tests.tiny import CELLS, run_cell, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _state_unchanged(orig):
    def step(self, state, iq_i, iq_q):
        _, out = orig(self, state, iq_i, iq_q)
        return state, out
    return step


def _half_left_out(orig):
    def step(self, state, iq_i, iq_q):
        new, out = orig(self, state, iq_i, iq_q)
        c = self.config.channels
        rows = out.packed.view(c, -1)
        rows[1::2] = 0
        return new, out
    return step


def _answer_altered(orig):
    def step(self, state, iq_i, iq_q):
        new, out = orig(self, state, iq_i, iq_q)
        c, k = self.config.channels, self.config.k_slots
        nc = self.config.wire_ncols
        rows = out.packed.view(c, -1)
        frames = rows[:, :k * nc].view(c, k, nc)
        frames[:, :, nc // 2] ^= 1
        return new, out
    return step


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(root, cell, fault, monkeypatch, capsys):
    from sondetpu_torch.runtime.pipeline import Pipeline

    monkeypatch.setattr(Pipeline, "_step_impl", fault(Pipeline._step_impl))
    res = run_cell(root, cell, 31, seconds=0.5, capsys=capsys)
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_step_is_correct(root, cell, capsys):
    res = run_cell(root, cell, 32, seconds=0.5, capsys=capsys)
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "cpu"


def _weak_bits_altered(orig):
    def step(self, state, iq_i, iq_q):
        new, out = orig(self, state, iq_i, iq_q)
        c = self.config
        if c.chase_m:
            rows = out.packed.view(c.channels, -1)
            off = c.k_slots * c.wire_ncols + 2 * c.k_slots + 4
            weak = rows[:, off:].contiguous().view(torch.int16) + 1
            rows[:, off:] = weak.view(torch.uint8)
        return new, out
    return step


def test_weak_bits_altered_is_caught(root, monkeypatch, capsys):
    """m10's Chase weak bits, each moved one bit along where they are
    packed: the weak-bit gap reads far above its limit."""
    from sondetpu_torch.runtime.pipeline import Pipeline

    monkeypatch.setattr(Pipeline, "_step_impl",
                        _weak_bits_altered(Pipeline._step_impl))
    res = run_cell(root, "fleet-2048.bench-mix", 33, seconds=0.5,
                   capsys=capsys)
    weak = res["check"]["weak_gap"]
    assert res["correct"] is False and weak["value"] > 10 * weak["limit"], \
        res["check"]
