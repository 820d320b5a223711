"""The comparison that decides ``correct`` fails when the timed path is
broken underneath: a run on the CPU at small sizes, past the look for a
card, with the port patched.

Which faults a cell can have is its traffic driver's ``FAULTS``; the
half-batch fault cuts the ``train_step`` of each class the driver names
in ``TRAINERS`` along its ``BATCH_AXIS``."""

import importlib

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import cells
from tiny import config, limits, mix

BENCH = cells.benchmark()


def driver(name):
    return cells.module("traffic", cells.mix(cells.cell(name, BENCH)["traffic"])["driver"])


def cells_with(fault):
    return [w["name"] for w in BENCH["workloads"] if fault in driver(w["name"]).FAULTS]


def tiny_run(name):
    cell = cells.cell(name, BENCH)
    return run.run_cell(name, 11, 0.3, False, device="cpu", cfg=config(cell["config"]),
                        mix=mix(cell["traffic"]), limits=limits(name))


def test_every_fault_a_driver_declares_has_a_test():
    known = {"state_unchanged", "half_batch", "answer_altered", "waveform_altered",
             "half_windows"}
    for w in BENCH["workloads"]:
        assert set(driver(w["name"]).FAULTS) <= known, w["name"]


@pytest.mark.parametrize("name", cells_with("state_unchanged"))
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from decode_tonal_langauge_tpu_torch.training import optim

    monkeypatch.setattr(optim.NAdam, "step", lambda self, grads=None: None)
    assert tiny_run(name)["correct"] is False


@pytest.mark.parametrize("name", cells_with("half_batch"))
def test_half_of_the_batch_left_out(name, monkeypatch):
    d = driver(name)
    axis = d.BATCH_AXIS
    for path in d.TRAINERS:
        module, _, cls_name = path.rpartition(".")
        cls = getattr(importlib.import_module(module), cls_name)
        step = cls.train_step

        def half(self, *args, _step=step):
            *batch, _ = args
            batch = [t.narrow(axis, 0, t.shape[axis] // 2) for t in batch]
            return _step(self, *batch, batch[-1].sum(axis))

        monkeypatch.setattr(cls, "train_step", half)
    assert tiny_run(name)["correct"] is False


@pytest.mark.parametrize("name", cells_with("answer_altered"))
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    from decode_tonal_langauge_tpu_torch.serving import TonalDecoder

    inner = TonalDecoder._decode

    def altered(self, *args):
        tones, sylls, pt, ps, mel = inner(self, *args)
        mel = mel.clone()
        mel[-1, 0] += 0.1  # dB
        return tones, sylls, pt, ps, mel

    monkeypatch.setattr(TonalDecoder, "_decode", altered)
    res = tiny_run(name)
    assert res["correct"] is False and res["checks"]["mel_gap_db"]["value"] > 0.05


@pytest.mark.parametrize("name", cells_with("waveform_altered"))
def test_a_waveform_altered_where_it_is_produced(name, monkeypatch):
    from decode_tonal_langauge_tpu_torch.serving import TonalDecoder

    inner = TonalDecoder.synthesize_wavs

    def altered(self, *args, **kwargs):
        waves = inner(self, *args, **kwargs)
        waves[0] = waves[0][::-1].copy()  # another waveform of the same length
        return waves

    monkeypatch.setattr(TonalDecoder, "synthesize_wavs", altered)
    assert tiny_run(name)["correct"] is False


@pytest.mark.parametrize("name", cells_with("half_windows"))
def test_half_of_the_windows_left_out(name, monkeypatch):
    from decode_tonal_langauge_tpu_torch.serving import TonalDecoder

    inner = TonalDecoder.decode

    def half(self, ecog, channels):
        n = ecog.shape[0]
        out = inner(self, ecog[:(n + 1) // 2], channels)
        return {k: np.concatenate([v, v])[:n] for k, v in out.items()}

    monkeypatch.setattr(TonalDecoder, "decode", half)
    assert tiny_run(name)["correct"] is False
