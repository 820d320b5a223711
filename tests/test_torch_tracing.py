"""The port's layer spans (``runtime/profiling.py``), on the CPU.

- With no profiler running and no recording active, no span enters
  ``torch.profiler.record_function``.
- A recording nests spans, links each to its parent on the same thread,
  and computes self time (a span less its children on its own thread).
- Under ``torch.profiler`` every span of the layer table appears in the
  exported trace of a seed-batched CNN-RNN ``train_step`` (and a
  ``ClassifierTrainer`` step), of ``TonalDecoder.decode`` +
  ``synthesize_wavs`` and of ``decode_stream``.
- Losses, weights, ids, mels and waves are bit-identical with spans off,
  recorded, and annotated under a profiler.
- A recorded span converts through the recording's anchor to within
  5 ms of its own ``user_annotation``.
"""

import contextlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from decode_tonal_langauge_tpu_torch import serving
from decode_tonal_langauge_tpu_torch.models import deep, simple
from decode_tonal_langauge_tpu_torch.models.base import init_params
from decode_tonal_langauge_tpu_torch.models.factory import build_synthesis_model
from decode_tonal_langauge_tpu_torch.runtime import profiling
from decode_tonal_langauge_tpu_torch.runtime.profiling import StageTimer, recording, span
from decode_tonal_langauge_tpu_torch.training.seed_parallel import SeedParallelTrainer
from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

T, SEEDS, BATCH = 40, [3, 17], 4
CHANNELS = {"active_channels": list(range(7)), "tone_discriminative": [0, 1],
            "syllable_discriminative": [2, 3]}
MAPPING = {"0": [0.1, 0.2, 0.3], "1": [0.4, 0.5, 0.6], "2": [0.7, 0.8, 0.9]}
MEL_KWARGS = {"n_mels": 4, "n_fft": 64, "hop_length": 16}
SR, MEL_DIM = 800, 4 * 4

FIT_SPANS = {"trainer.step", "seed_stack.masks", "seed_stack.grad_step", "seed_stack.forward",
             "lstm.forward", "lstm.reverse", "lstm.weight_grads", "optim.nadam"}
DECODE_SPANS = {"decoder.decode", "decoder.tone", "decoder.syllable", "decoder.synthesis",
                "decoder.fetch", "lstm.forward", "audio.mels_to_audio", "audio.basis",
                "audio.nnls", "audio.nnls_setup", "audio.griffinlim", "audio.fetch"}
STREAM_SPANS = {"decoder.decode_stream", "decoder.gather", "decoder.decode", "decoder.tone",
                "decoder.syllable", "decoder.synthesis", "decoder.fetch", "lstm.forward"}


def _cnnrnn():
    return deep.CNNRNNClassifier(2, T, 3, lstm_dim=80)


def _fit_step():
    """One seed-batched CNN-RNN step from fixed weights and data: (losses,
    every stacked weight after the step)."""
    spt = SeedParallelTrainer(_cnnrnn(), 3, SEEDS, weight_decay=0.01, device="cpu")
    spt.init()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, BATCH, 2, T)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 3, (2, BATCH)))
    w = torch.ones(2, BATCH)
    loss, _ = spt.train_step(x, y, w, w.sum(1))
    return [loss] + [p.clone() for p in spt.stack.params.values()]


def _classifier_step():
    trainer = ClassifierTrainer(_cnnrnn(), 3, device="cpu")
    trainer.init(5)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((BATCH, 2, T)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 3, BATCH))
    w = torch.ones(BATCH)
    loss, _ = trainer.train_step(x, y, w, w.sum())
    return [loss] + [p.clone() for p in trainer.model.parameters()]


def _decode(dec):
    """Decode + Griffin-Lim of 2 epochs: every output, the waves last."""
    ecog = np.random.default_rng(2).standard_normal((2, 7, T)).astype(np.float32)
    out = dec.decode(ecog, CHANNELS)
    waves = dec.synthesize_wavs(out["mel"], SR, MEL_KWARGS)
    return [out[k] for k in sorted(out)] + waves


def _stream(dec):
    rec = np.random.default_rng(3).standard_normal((7, 3 * T)).astype(np.float32)
    out = dec.decode_stream(rec, CHANNELS, T, T // 2, max_batch=3)
    return [out[k] for k in sorted(out)]


def _annotations(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        raw = json.load(f)
    return raw, [e for e in raw["traceEvents"] if e.get("cat") == "user_annotation"]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case run with spans off, inside a recording and under the
    profiler: {case: (off, recorded, profiled, the trace's span names)},
    and every call of ``record_function`` while the spans were off."""
    dec = serving.TonalDecoder(
        init_params(deep.CNNRNNClassifier(2, T, 3, lstm_dim=T), 0),
        init_params(simple.LogisticRegressionClassifier(2 * T, 2), 1), MAPPING,
        synthesis_model=init_params(build_synthesis_model("SynthesisLite", MEL_DIM, 3, T), 2),
        device="cpu")
    cases = {"fit": _fit_step, "classifier": _classifier_step,
             "decode": lambda: _decode(dec), "stream": lambda: _stream(dec)}
    calls, out = [], {}
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case, run in cases.items():
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch.profiler, "record_function", counting)
                off = run()
            with recording() as rec:
                recorded = run()
            assert rec.spans
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                profiled = run()
            notes = _annotations(prof, tmp_path_factory.mktemp(case) / "trace.json")[1]
            out[case] = (off, recorded, profiled, {e["name"] for e in notes})
    finally:
        torch.set_num_threads(n)
    return out, calls


def test_spans_off_never_enter_record_function(runs, monkeypatch):
    _, calls = runs
    assert calls == []
    assert profiling.span("x") is profiling.span("y")  # the shared no-op
    seen = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: seen.append(name) or contextlib.nullcontext())
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    with span("optim.nadam"):  # the patch sees a span's call under a profiler
        pass
    assert seen == ["optim.nadam"]


class _Clock:
    """``time`` for the profiling module: ``perf_counter_ns`` reads the
    given ticks in turn; Unix time stands at 1 ms."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter_ns(self):
        return next(self.ticks)

    def time_ns(self):
        return 1_000_000


def test_recording_nests_links_parents_and_computes_self_time(monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock([0, 10, 30, 40, 45, 50, 90, 100, 120]))

    def work():
        with span("t"):
            pass

    with recording() as rec:  # the anchor: perf 0 is Unix 1 ms
        with span("a"):  # 10 -> 120
            with span("b"):  # 30 -> 40
                pass
            with span("c"):  # 45 -> 100
                thread = threading.Thread(target=work)  # "t": 50 -> 90
                thread.start()
                thread.join(timeout=10)
                assert not thread.is_alive()
    a, b, c, t = rec.spans
    assert [s.name for s in rec.spans] == ["a", "b", "c", "t"]
    assert (a.parent, b.parent, c.parent, t.parent) == (None, 0, 0, None)
    assert t.thread != a.thread == b.thread == c.thread
    assert [(s.start_ns, s.end_ns) for s in rec.spans] == [(10, 120), (30, 40), (45, 100),
                                                           (50, 90)]
    assert rec.self_ns() == [45, 10, 55, 40]  # "c" keeps the other thread's time
    assert rec.trace_us(50, 0) == pytest.approx(1_000.05)
    assert rec.by_name()["a"] == {"count": 1, "total_s": pytest.approx(110e-9),
                                  "self_s": pytest.approx(45e-9)}
    assert profiling._recording is None


def test_the_stage_timer_is_a_view_over_the_recording(monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock(range(0, 1000, 10)))
    timer = StageTimer()  # the anchor: tick 0
    for stage in ("train", "eval", "train"):  # 6 ticks a stage
        with timer.span(stage):
            with span("lstm.forward"):
                with span("lstm.reverse"):
                    pass
    rec = timer.recording
    assert [s.name for s in rec.spans][:3] == ["train", "lstm.forward", "lstm.reverse"]
    assert [s.parent for s in rec.spans][:3] == [None, 0, 1]
    assert rec.self_ns()[:3] == [20, 20, 10]
    assert timer.spans == {"train": pytest.approx(100e-9), "eval": pytest.approx(50e-9)}
    assert timer.summary().splitlines()[0].startswith("train:")
    lines = timer.layers().splitlines()
    assert [line.split(":")[0] for line in lines] == ["lstm.forward", "lstm.reverse"]
    assert "3 calls" in lines[0]
    assert profiling._recording is None  # the timer records only inside its stages


def test_every_span_appears_under_the_profiler(runs):
    names = {case: r[3] for case, r in runs[0].items()}
    assert FIT_SPANS <= names["fit"], FIT_SPANS - names["fit"]
    assert {"trainer.step", "lstm.forward", "lstm.reverse", "lstm.weight_grads",
            "optim.nadam"} <= names["classifier"]
    assert DECODE_SPANS <= names["decode"], DECODE_SPANS - names["decode"]
    assert STREAM_SPANS <= names["stream"], STREAM_SPANS - names["stream"]


@pytest.mark.parametrize("case", ["fit", "classifier", "decode", "stream"])
def test_numbers_are_bit_identical_with_spans_on_and_off(case, runs):
    off, recorded, profiled, _ = runs[0][case]
    _equal(off, recorded)
    _equal(off, profiled)


def test_a_recorded_span_meets_its_annotation_through_the_anchor(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as rec:
        with span("audio.griffinlim"):
            torch.ones(64).cumsum(0)
    raw, notes = _annotations(prof, tmp_path / "trace.json")
    (note,) = [e for e in notes if e["name"] == "audio.griffinlim"]
    (s,) = rec.spans
    base = raw["baseTimeNanoseconds"]
    assert abs(rec.trace_us(s.start_ns, base) - note["ts"]) < 5e3
    assert abs(rec.trace_us(s.end_ns, base) - (note["ts"] + note["dur"])) < 5e3
