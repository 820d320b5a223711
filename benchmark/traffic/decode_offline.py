"""Traffic ``decode_offline``: a whole recorded session decoded at once,
again and again for the window.

Set-up builds the port's ``TonalDecoder`` from the harness's seeded
weights and scalers, makes one recording of ``recording_s`` seconds (all
channels) and warms up with one pass. Each pass of the window is one
``TonalDecoder.decode_stream`` of the recording (every ``hop``-spaced
``window``-sample slice, in chunks of at most ``max_batch``), its labels
and mels on the host. Every pass's outputs are kept: the reference
decodes each distinct window once and every answer of every pass is
compared with it.

Mix parameters: ``recording_s``, ``window``, ``hop``, ``sample_rate_hz``,
``max_batch``, ``trace_passes``, ``margin``.

``FAULTS``: what the benchmark's tests break underneath
(``tests/test_bench_faults.py``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict

import numpy as np

from benchmark.harness import decode_check, inputs, program, weights

FAULTS = ("answer_altered", "half_windows")


def _recording(ctx) -> np.ndarray:
    ch, mix = ctx.cfg["channels"], ctx.mix
    total = ch["tone"] + ch["syllable"] + ch["non_discriminative"]
    return inputs.recording(inputs.rng(ctx.seed, "recording"), total,
                            int(mix["recording_s"] * mix["sample_rate_hz"]))


def _n_windows(ctx, rec: np.ndarray) -> int:
    return (rec.shape[1] - ctx.mix["window"]) // ctx.mix["hop"] + 1


def setup(ctx) -> SimpleNamespace:
    cfg = ctx.cfg
    w = program.decode_weights(cfg, ctx.seed, ctx.device)
    st = SimpleNamespace(
        dec=program.decoder(cfg, w, program.scalers(cfg, ctx.seed), ctx.device),
        sums={k: weights.checksums(v) for k, v in w.items()},
        channels=inputs.channel_selection(cfg), rec=_recording(ctx), kept=[])
    del w
    st.n_windows = _n_windows(ctx, st.rec)
    one_pass(ctx, st)
    return st


def one_pass(ctx, st) -> Dict[str, np.ndarray]:
    mix = ctx.mix
    with ctx.span("decode_stream"):
        return st.dec.decode_stream(st.rec, st.channels, mix["window"], mix["hop"],
                                    max_batch=mix["max_batch"])


def window(ctx, st, seconds: float) -> Dict:
    t0 = time.perf_counter()
    passes = failed = 0
    while True:
        out = one_pass(ctx, st)
        passes += 1
        failed += int((~np.isfinite(out["mel"]).all(axis=1)).sum())
        st.kept.append(out)
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    n = passes * st.n_windows
    print(f"offline window: {passes} passes of {st.n_windows} windows in {wall:.4f} s",
          file=ctx.log)
    return {"metrics": {"decode_windows_per_s": n / wall}, "attempted": n, "failed": failed,
            "rate": n / wall}


def traced(ctx, st, profile) -> int:
    n = ctx.mix["trace_passes"]
    with profile():
        for _ in range(n):
            one_pass(ctx, st)
    with profile(host_ops=True):
        one_pass(ctx, st)
    return n * st.n_windows


def release(ctx, st) -> Dict:
    """Every pass's answers, laid end to end, with the window each is of."""
    keys = [k for k in st.kept[0] if k != "window_start"]
    prog = {k: np.concatenate([o[k] for o in st.kept]) for k in keys}
    st.dec = None
    return {"rows": np.tile(np.arange(st.n_windows), len(st.kept)), "prog": prog,
            "sums": st.sums}


def _reference(ctx, precision: str = "f64", sums=None) -> Dict[str, np.ndarray]:
    """The reference on every window of the recording, cut again here."""
    rec = _recording(ctx)
    hop, win = ctx.mix["hop"], ctx.mix["window"]
    windows = np.stack([rec[:, i * hop:i * hop + win] for i in range(_n_windows(ctx, rec))])
    return decode_check.reference(ctx.cfg, ctx.seed, windows, ctx.device, precision, sums=sums)


def judge(ctx, r: Dict) -> Dict[str, float]:
    """Every answer of every pass against the reference's for its window."""
    ref = _reference(ctx, sums=r["sums"])
    return decode_check.gaps(r["prog"], {k: v[r["rows"]] for k, v in ref.items()},
                             ctx.mix["margin"])


def control(ctx, mode: str) -> Dict[str, float]:
    """The numbers compared when the reference in precision ``mode``
    stands in the port's place, on every window of the recording."""
    return decode_check.gaps(_reference(ctx, mode), _reference(ctx), ctx.mix["margin"])
