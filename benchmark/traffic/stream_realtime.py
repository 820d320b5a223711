"""Traffic ``stream_realtime``: one continuous recording decoded as it
arrives, open loop.

Set-up builds the port's ``TonalDecoder`` from the harness's seeded
weights and scalers, makes the recording (all channels at the mix's rate,
as long as the window needs) and warms up on its first windows. In the
window, every ``hop`` samples the newest ``window``-sample slice is due;
the harness hands it from host memory to ``TonalDecoder.decode``, then
its mel to ``TonalDecoder.synthesize_wavs`` with a fixed first phase, and
the window's latency runs from when it was due to when its waveform is
on the host. A window that waits behind the one before counts the wait;
none is skipped. Every window's outputs are kept for the reference.

Mix parameters: ``window``, ``hop``, ``sample_rate_hz``,
``warmup_windows``, ``trace_windows``, ``margin``.

``FAULTS``: what the benchmark's tests break underneath
(``tests/test_bench_faults.py``).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np

from benchmark.harness import decode_check, inputs, program, weights

FAULTS = ("answer_altered", "waveform_altered")
_SPIN_S = 0.002  # the last part of a wait is spun, so that waking is on time


def _n_windows(ctx) -> int:
    return max(1, int(round(ctx.seconds * ctx.mix["sample_rate_hz"] / ctx.mix["hop"])))


def _recording(ctx, n: int) -> np.ndarray:
    ch = ctx.cfg["channels"]
    total = ch["tone"] + ch["syllable"] + ch["non_discriminative"]
    return inputs.recording(inputs.rng(ctx.seed, "recording"), total,
                            (n - 1) * ctx.mix["hop"] + ctx.mix["window"])


def setup(ctx) -> SimpleNamespace:
    cfg = ctx.cfg
    w = program.decode_weights(cfg, ctx.seed, ctx.device)
    st = SimpleNamespace(
        dec=program.decoder(cfg, w, program.scalers(cfg, ctx.seed), ctx.device),
        sums={k: weights.checksums(v) for k, v in w.items()}, n=_n_windows(ctx),
        channels=inputs.channel_selection(cfg), phase=program.init_phase(cfg, ctx.seed, ctx.device),
        mel_kwargs=program.mel_kwargs(cfg), kept=[])
    del w
    st.rec = _recording(ctx, st.n)
    for i in range(min(ctx.mix["warmup_windows"], st.n)):
        serve(ctx, st, i)
    return st


def serve(ctx, st, i: int):
    """Window ``i`` through the decoder and Griffin-Lim; outputs on the host."""
    lo = i * ctx.mix["hop"]
    x = st.rec[None, :, lo:lo + ctx.mix["window"]]
    with ctx.span("decode"):
        out = st.dec.decode(x, st.channels)
    with ctx.span("griffinlim"):
        wave = st.dec.synthesize_wavs(out["mel"], ctx.cfg["mel"]["sample_rate_hz"],
                                      st.mel_kwargs, init_phase=st.phase)[0]
    return out, wave


def _wait(ctx, due: float) -> None:
    with ctx.span("wait"):
        while True:
            left = due - time.perf_counter()
            if left <= 0:
                return
            if left > _SPIN_S:
                time.sleep(left - _SPIN_S)


def run_windows(ctx, st, n: int, keep: bool):
    """Windows 0..n-1, each started when due (or when the one before ends)."""
    period = ctx.mix["hop"] / ctx.mix["sample_rate_hz"]
    t0 = time.perf_counter() + period
    latency, lateness, failed = [], [], 0
    for i in range(n):
        due = t0 + i * period
        _wait(ctx, due)
        start = time.perf_counter()
        out, wave = serve(ctx, st, i)
        done = time.perf_counter()
        latency.append(done - due)
        lateness.append(start - due)
        failed += not (np.isfinite(out["mel"]).all() and np.isfinite(wave).all())
        if keep:
            st.kept.append(dict({k: v[0] for k, v in out.items()}, wave=wave))
    return np.array(latency), np.array(lateness), failed, done - t0


def window(ctx, st, seconds: float) -> Dict:
    pauses, start = [], []

    def on_gc(phase, info):  # the interpreter's collections during the window
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append((info["generation"], time.perf_counter() - start.pop()))

    gc.callbacks.append(on_gc)
    try:
        latency, lateness, failed, wall = run_windows(ctx, st, st.n, keep=True)
    finally:
        gc.callbacks.remove(on_gc)
    gen2 = [p for g, p in pauses if g == 2]
    print(f"stream window: {len(pauses)} garbage collections, {sum(p for _, p in pauses) * 1e3:.4f} "
          f"ms in all; {len(gen2)} of the oldest generation, longest "
          f"{max(gen2, default=0.0) * 1e3:.4f} ms", file=ctx.log)
    print(f"stream window: {st.n} windows due over {wall:.4f} s; latency ms p50 "
          f"{np.median(latency) * 1e3:.4f} p95 {np.percentile(latency, 95) * 1e3:.4f} max "
          f"{latency.max() * 1e3:.4f}; the generator ran late (start - due) ms p50 "
          f"{np.median(lateness) * 1e3:.4f} p95 {np.percentile(lateness, 95) * 1e3:.4f} max "
          f"{lateness.max() * 1e3:.4f}", file=ctx.log)
    return {"metrics": {"window_latency_p95_ms": float(np.percentile(latency, 95) * 1e3)},
            "attempted": st.n, "failed": failed}


def traced(ctx, st, profile) -> int:
    n = min(ctx.mix["trace_windows"], st.n)
    with profile():
        run_windows(ctx, st, n, keep=False)
    with profile(host_ops=True):
        run_windows(ctx, st, 1, keep=False)
    return n


def release(ctx, st) -> Dict:
    kept = {k: np.stack([row[k] for row in st.kept]) for k in st.kept[0]}
    st.dec = None
    return {"prog": kept, "sums": st.sums, "n": st.n}


def _windows(ctx, n: int) -> np.ndarray:
    hop, win = ctx.mix["hop"], ctx.mix["window"]
    rec = _recording(ctx, n)
    return np.stack([rec[:, i * hop:i * hop + win] for i in range(n)])


def judge(ctx, r: Dict) -> Dict[str, float]:
    """Every window of the measured window against the reference."""
    windows = _windows(ctx, r["n"])
    phase = program.init_phase(ctx.cfg, ctx.seed, ctx.device)
    ref = decode_check.reference(ctx.cfg, ctx.seed, windows, ctx.device, phase=phase,
                                 sums=r["sums"])
    return decode_check.gaps(r["prog"], ref, ctx.mix["margin"])


def control(ctx, mode: str) -> Dict[str, float]:
    """The numbers compared when the reference in precision ``mode``
    stands in the port's place, on the windows a run with this seed
    decodes."""
    windows = _windows(ctx, _n_windows(ctx))
    phase = program.init_phase(ctx.cfg, ctx.seed, ctx.device)
    stand_in = decode_check.reference(ctx.cfg, ctx.seed, windows, ctx.device, mode, phase=phase)
    ref = decode_check.reference(ctx.cfg, ctx.seed, windows, ctx.device, phase=phase)
    return decode_check.gaps(stand_in, ref, ctx.mix["margin"])
