#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port
(``decode_tonal_langauge_tpu_torch``), never the JAX package, and fails
(non-zero exit, no result line) when any check fails, when no CUDA card is
present, or when the port's sources are not beside it.

1. Prints the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and builds every CUDA kernel from ``csrc/`` (seconds, ptxas).
2. K1 phase: the port's ``ops.iir.lfilter`` on a (128, 183120) f32 signal
   (60 s at 3052 Hz) with an order-8 Butterworth band and an initial
   state, the route that launches the three-pass ``iir_df2t`` kernel.
   Checks that the kernel launched, holds y and zf against SciPy in
   float64 (rtol 1e-3, atol 1e-3), holds the kernel against its plain
   torch version (``lfilter_chunked_reference``) on the card within 1e-6
   at that shape and at (128, 2*4096+37), and against the serial plain
   recurrence within 1e-3 at the latter; runs a 20-tap FIR (order 19, the
   generic instance) against SciPy and the plain version; times the
   kernel, each of its passes and the plain version.
3. Preprocess phase: the stage's entry point ``preprocess.main.run`` on
   the card over one subject of two blocks, each 128 channels x 60 s of
   seeded noise plus a passthrough audio track, at 3052 Hz (the polyphase
   conv route) and at the TDT rate 3051.7578125 Hz (the gather route),
   with the example chain: downsample to 400 Hz, a 70-150 Hz Hilbert
   envelope band and a 0.3-100 Hz order-4 Butterworth band, z-score over
   [0, 25] s. Checks the block files, rates, shapes and finiteness; holds
   the card's block against the port on the CPU (rtol/atol 1e-3) and a
   SciPy/numpy chain (correlation >= 0.99 outside the first and last 5 s);
   prints the stage's wall time, recording-seconds/s of
   ``preprocess_signal``, each step's device time, the top device
   operations of one call (``torch.profiler``) and how many times K1
   launched (none: the stage is not on K1's path).
4. Training phase: the classifier-training stage through
   ``training.train_classifier.run`` on the card at the paper's widths: a
   seeded synthetic subject (320 trials of 6 channels x 200 samples, 4
   tones, 8 syllables, class-dependent contours over noise), the CNN for
   syllables and the CNN-RNN (lstm_dim 800) for tones, 2 seeds, batch 32,
   3 epochs, lr 5e-4, weight decay 0.01, standardised, checkpoints saved.
   Checks results.csv (joint, syllable and tone rows, finite), the class
   counts, the 4 checkpoints and 3-row histories; serves the checkpoints
   back through ``serving.load_decoder`` on the card (ids equal to the
   trainer's test predictions); holds two NAdam steps of the full-width
   CNN and CNN-RNN on the card against the CPU, each against a float64
   twin that follows its branch (the rule at STEP_LOSS_TOL, with a TF32
   control that must break it); prints the stage wall, peak device
   memory, each model's median train-step time and trials/s, and the
   device work of one step (busy share, operations, the top ones from
   ``torch.profiler``); K1 must launch 0 times.
5. Seed-parallel phase: the batched fit of every repeat seed
   (``training/seed_parallel.py``) against the seed loop. Two NAdam steps
   of the stacked seeds of the full-width CNN, CNN-RNN and SynthesisFull
   in float64 (dropout on) against each seed's own steps, every weight
   within 1e-9; 4 seeds x 3 epochs of the CNN (syllables) and CNN-RNN
   (tones, lstm_dim 800) on the training phase's subject at batch 32
   (``SeedParallelTrainer.fit_eval`` against ``fit_seed`` per seed, and
   the loop again under deterministic cuDNN as the yardstick of float32
   order; rows, flips and accuracies printed, epochs and stops equal);
   ``train_synthesizer.run`` at the SynthesisFull widths with 4 seeds,
   ``--seed_parallel 1`` against ``0``: per-seed losses, MCDs and test MCDs
   by the JAX package's rule (rel 2e-3 / abs 2e-4) and both walls, two
   batched SynthesisFull gradients equal under deterministic cuDNN; one
   batched step of the 4 seeds against the loop's 4 steps for each model
   (median of 10, busy share, operations, peak memory, the convolution
   kernels cuDNN picked); ``configs/fast_bf16.yaml`` through the runner
   with ``seed_parallel`` on and off (evaluation rows equal to training's
   in both, flips between them and both walls printed); two gloo ranks
   sharing the card with the CNN's seeds sharded over them, every rank's
   rows, predictions and weights equal to one process's fit of the same
   seed blocks; K1 0 launches. The argument for the rules is beside
   SP_SEEDS.
6. Synthesizer phase: a synthetic subject (``data/synthetic``) through the
   preprocess stage and ``data/extract_samples.run`` (npz keys, shapes,
   labels equal to the events); then ``train_synthesizer.run`` at the
   paper's SynthesisFull widths (101.8 M parameters: 96 trials of 40
   non-discriminative + 6 tone + 6 syllable channels x 200 samples,
   100-step label dynamics, mel 128 x 20 from 0.4 s of audio; seeded
   CNN-RNN tone and CNN syllable checkpoints with scalers; batch 8, 2
   seeds x 3 epochs, ``--checkpoint_dir``, ``--train_state_dir``, WAVs):
   files, rows and MCDs below the zero predictor's; ``--evaluate_only``
   repeats each seed's row exactly; 2 epochs then ``--resume`` to 3 equal
   the straight fit bit for bit; the serving CLI on a checkpoint reports
   ``mel_mcd`` and ``mel_pearson_r``, and its test mels, decoded in
   batches of 8, lie within 1e-3 of ``evaluate``'s; the step timed at
   batch 8 and 32 (trials/s, device ms, busy share, top ops); two NAdam
   steps card vs CPU vs float64 with the TF32 control; K1 0 launches.
7. Serving phase at the paper's widths (CNN-RNN tone and CNN syllable
   models on 6 channels each, SynthesisLite on 20, 200-sample epochs,
   4 tones, 8 syllables, mel_dim 2560, Griffin-Lim at sr 24414 with n_fft
   2048, hop 512, 32 iterations) with seeded random weights: the serving
   CLI in epoch mode (32 trials, 4 waves) and stream mode (60 s at 400 Hz,
   window 200, hop 40: 596 windows), then the same epoch decode on the
   card and on the CPU, which must agree. Prints trials/s, windows/s and
   waves/s beside the card's name and power limit.
8. Pipeline phase: ``configs/example_config.yaml`` through
   ``pipeline.run_pipeline`` on the card (preprocess, sample collection,
   channel selection, training, evaluation, visualisation) on a synthetic
   subject (``data/synthetic``) of 128 channels at 1000 Hz, 2 blocks x 160
   trials (4 tones x 2 syllables), 0.5 s epochs, active / tone / syllable
   selection at p 0.05 and 0.05 s, the CNN syllable and CNN-RNN (lstm_dim
   800) tone pair, 2 seeds x 3 epochs at batch 32 with checkpoints. Checks
   each stage's output and its threading, the planted channels in each
   set, the stage's JSON equal on a warm rerun and on the CPU and p within
   rtol 1e-4 (p < 1e-3) / atol 1e-3 of the CPU's, evaluation rows equal to
   training's, ``serving --training_dir`` on the subject and on the first
   seed's test trials in the trainer's batches (ids equal to the
   trainer's), no figures without matplotlib, K1 0 launches; prints the
   stage timing, the wall, peak memory, and each ANOVA's wall, device time
   and operations (``torch.profiler``).
9. bf16 phase (``configs/fast_bf16.yaml``'s compute dtype): one train step
   of the full-width CNN and CNN-RNN at batch 32 and of SynthesisFull at
   batch 8 and 32 in float32, in bf16 and in bf16 with cuBLAS's bf16
   reductions allowed, from the same seeded weights (median of 10 after 3
   warm-ups, busy share, operations, top device ops, peak memory, and a
   ``bf16 step table:`` JSON line); bf16 forwards on the card and the CPU
   (probabilities within 2e-3, ids equal where the top-2 margin exceeds it,
   outputs off the bf16 grid, mels within four bf16 roundings); two bf16
   SynthesisFull gradients equal under deterministic cuDNN;
   ``configs/fast_bf16.yaml`` through ``pipeline.run_pipeline`` on the
   pipeline phase's subject (epochs cut from 60 to 3; 4 seeds, batch 32,
   lstm_dim 800 kept; rows equal, the bf16 models in the rows and the
   provenance, ``serving --training_dir`` ids equal to the trainer's); and
   ``train_synthesizer --dtype bfloat16 --moment_dtype bfloat16`` (1 seed x
   3 epochs, MCD below the zero predictor's) served with
   ``--synthesis_dtype bfloat16`` (test mels within four bf16 roundings of
   ``evaluate``'s); K1 0 launches.
10. Parallel phase (``parallel/``): (a) one train step of the full-width
   CNN and CNN-RNN (batch 32) and SynthesisFull (batch 8) through the
   data-parallel layout on a one-rank NCCL group, equal to the plain step
   bit for bit; (b) a ``torch.distributed.run`` launch of two ranks
   sharing the card over gloo (this script with ``--parallel-worker``):
   two NAdam steps of each model, dropout on and a padded batch, at the
   global batch against the same steps in one process (float32 losses
   rtol 1e-4; in float64 losses rtol 1e-9 and every weight within 1e-9;
   the argument is beside PAR_F64_ATOL), equal weights on both ranks,
   step and all-reduce times; (c) in the same launch the pipeline runner
   over two synthetic subjects (a narrowing of the pipeline phase's: 32
   channels, 2 x 48 trials a subject), one subject a rank, merged rows
   equal to the one-process run's and evaluation's equal to training's;
   (d) ``serving --parallel_data 2`` ids equal to the one-process decode,
   mels within 1e-5; (e) with two or more cards, (b)'s steps over NCCL
   one rank per card (skipped, with a note, on one card). Every launch has
   a timeout; K1 0 launches in every process.
11. Demo phase: ``scripts/demo_end_to_end_torch.py`` (the port's
   one-command demo: synthetic subject -> YAML pipeline with per-target
   logistic / shallow-MLP classifiers over 2 batched seeds, evaluation
   and visualisation -> ``train_synthesizer`` (SynthesisLite) -> the
   serving CLI on epochs -> the serving CLI streaming a block) run in this
   process on the card, at the demo's own widths, in a fresh directory.
   Checks the file layout (no figures without matplotlib), every CSV
   finite, the stream's windows, the 23 WAVs at 800 Hz, evaluation rows
   equal to training's; loads the demo's checkpoints on the CPU through
   ``serving.load_decoder`` and decodes the same epochs: ids equal to the
   card's where the top-2 margin exceeds 1e-4, mels within rtol/atol
   1e-3; K1 0 launches; prints each step's wall beside the card's name
   and power limit.
12. Prints each phase's wall time, the ``kernels`` JSON line, then the
   final ``ok`` JSON line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def max_err(got, want) -> float:
    """Largest absolute difference over paired tensors (y, zf)."""
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def k1_phase(card: str) -> dict:
    import scipy.signal as sps
    import torch

    from decode_tonal_langauge_tpu_torch._timing import kernel_ms, time_ms
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir, iir

    rows, t = 128, 183120
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, t)).astype(np.float32)
    b, a = sps.butter(4, [0.1, 0.4], btype="bandpass")  # order 8
    order = len(a) - 1
    zi = iir.lfilter_zi(b, a)[None, :] * x[:, :1].astype(np.float64)
    xd = torch.from_numpy(x).cuda()
    zid = torch.from_numpy(zi.astype(np.float32)).cuda()

    # The main path: the port's lfilter, K1 route.
    cuda_iir.LAUNCHES = 0
    y, zf = iir.lfilter(b, a, xd, zi=zid)
    torch.cuda.synchronize()
    launches = cuda_iir.LAUNCHES
    check(launches >= 1, "lfilter did not launch the iir_df2t kernel")

    ref_y, ref_zf = sps.lfilter(b, a, x.astype(np.float64), zi=zi, axis=-1)
    y_np, zf_np = y.cpu().numpy(), zf.cpu().numpy()
    check(np.isfinite(y_np).all(), "K1: non-finite output")
    scipy_err = max(np.abs(y_np - ref_y).max(), np.abs(zf_np - ref_zf).max())
    check(np.allclose(y_np, ref_y, rtol=1e-3, atol=1e-3)
          and np.allclose(zf_np, ref_zf, rtol=1e-3, atol=1e-3),
          f"K1 vs scipy float64: max abs err {scipy_err}")

    # Kernel against its plain version (the same three passes in torch)
    # on the card. Both round every product and sum on its own in the same
    # order, so they should agree bit for bit; 1e-6 absolute (outputs are
    # O(1)) leaves room for no more than a last-bit difference. Against
    # the serial recurrence the rounding differs: 1e-3, SciPy's tolerance.
    tol = 1e-6
    t_tail = 2 * 4096 + 37
    xs = torch.from_numpy(
        rng.standard_normal((rows, t_tail)).astype(np.float32)).cuda()
    zs = torch.from_numpy(
        (iir.lfilter_zi(b, a)[None, :] * x[:, :1]).astype(np.float32)).cuda()
    got = cuda_iir.lfilter_cuda(b, a, xs, zi=zs)
    err_tail = max_err(got, cuda_iir.lfilter_chunked_reference(b, a, xs, zi=zs))
    check(err_tail <= tol, f"K1 kernel vs plain at {rows}x{t_tail}: {err_tail}")
    err_serial = max_err(got, cuda_iir.lfilter_reference(b, a, xs, zi=zs))
    check(err_serial <= 1e-3,
          f"K1 kernel vs serial plain at {rows}x{t_tail}: {err_serial}")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = cuda_iir.lfilter_chunked_reference(b, a, xd, zi=zid)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)  # one run: thousands of small launches
    err_main = max_err((y, zf), plain)
    check(err_main <= tol, f"K1 kernel vs plain at {rows}x{t}: {err_main}")

    # An order above the register instances: a 20-tap FIR (order 19) with
    # a seeded state, through lfilter, against SciPy and the plain version.
    fir = sps.firwin(20, 0.3)
    zi_fir = 0.1 * rng.standard_normal((rows, len(fir) - 1))
    zfd = torch.from_numpy(zi_fir.astype(np.float32)).cuda()
    got = iir.lfilter(fir, [1.0], xd, zi=zfd)
    ref_f = sps.lfilter(fir, [1.0], x.astype(np.float64), zi=zi_fir, axis=-1)
    fir_scipy_err = max(np.abs(g.cpu().numpy() - r).max() for g, r in zip(got, ref_f))
    check(all(np.allclose(g.cpu().numpy(), r, rtol=1e-3, atol=1e-3)
              for g, r in zip(got, ref_f)),
          f"K1 order-19 FIR vs scipy float64: max abs err {fir_scipy_err}")
    err_fir = max_err(got, cuda_iir.lfilter_chunked_reference(fir, [1.0], xd, zi=zfd))
    check(err_fir <= tol, f"K1 order-19 FIR kernel vs plain: {err_fir}")

    # The kernel's time is its three passes as the profiler saw them;
    # call_ms is one wrapper call made back to back with others, host work
    # included.
    main_call = lambda: cuda_iir.lfilter_cuda(b, a, xd, zi=zid)  # noqa: E731
    fir_call = lambda: cuda_iir.lfilter_cuda(fir, [1.0], xd, zi=zfd)  # noqa: E731
    pass_ms = kernel_ms(main_call, cuda_iir.PASS_KERNELS)
    fir_passes = kernel_ms(fir_call, cuda_iir.PASS_KERNELS)
    check(pass_ms is not None and fir_passes is not None,
          "torch.profiler saw no device time for one of K1's passes")
    ms, fir_ms = sum(pass_ms), sum(fir_passes)
    call_ms = time_ms(main_call)

    n_bytes = 4 * (2 * rows * t + 2 * rows * order)  # x, zi in; y, zf out
    n_ops = rows * t * (2 + 4 * order)  # y: mul + add; a state: 2 mul + 2 add
    bound_bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    bound_ops_ms = n_ops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"K1 iir_df2t {rows}x{t} order {order} chunk {cuda_iir.CHUNK}: "
          f"launches {launches}, scipy max abs err {scipy_err:.3g}, kernel "
          f"vs plain max abs err {err_main:.3g} (main) {err_tail:.3g} "
          f"({rows}x{t_tail}), vs serial plain {err_serial:.3g}; kernel "
          f"{ms:.4f} ms (passes {' + '.join(f'{v:.4f}' for v in pass_ms)} ms, "
          f"torch.profiler), wrapper call {call_ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms [{card}]")
    print(f"K1 iir_df2t {rows}x{t} 20-tap FIR (order 19, generic instance): "
          f"scipy max abs err {fir_scipy_err:.3g}, kernel vs plain "
          f"{err_fir:.3g}, kernel {fir_ms:.4f} ms [{card}]")
    return {
        "name": "iir_df2t",
        "route": "cuda",
        "source": "decode_tonal_langauge_tpu_torch/csrc/iir_df2t.cu",
        "replaces": "decode_tonal_langauge_tpu/ops/pallas_iir.py:71",
        "tpu_kernel": "ops/pallas_iir.py:_build_call",
        "launches": launches,
        "max_abs_err": max(err_main, err_tail, err_fir),
        "max_abs_err_vs_serial": err_serial,
        "max_abs_err_vs_scipy": max(scipy_err, fir_scipy_err),
        "ms": ms,
        "pass_ms": pass_ms,
        "call_ms": call_ms,  # one wrapper call, back to back, host included
        "chunk": cuda_iir.CHUNK,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes lfilter with zi
        "fir19_ms": fir_ms,
    }


PRE_CHANNELS, PRE_SECONDS, PRE_TARGET, AUDIO_SF = 128, 60, 400, 24414.0
# 3052 Hz takes the polyphase conv route (up 100, down 763); the TDT rate
# 3051.7578125 Hz the gather route (up 1109, down 8461).
PRE_RATES = (3052.0, 3051.7578125)
PRE_STEPS = [
    {"module": "preprocess.downsample", "params": {"downsample_freq": PRE_TARGET}},
    {"module": "preprocess.frequency_filter", "params": {"bands": [
        {"method": "hilbert", "params": {"freq_ranges": [70, 150], "envelope": True}},
        {"method": "butter", "params": {"freqs": [0.3, 100], "order": 4}},
    ]}},
    {"module": "preprocess.zscore_rereference",
     "params": {"rereference_interval": [0.0, 25.0]}},
]


def write_blocks(raw_dir: str, raw_sf: float, channels: int, seconds: int,
                 rng) -> list:
    """Two blocks of seeded standard-normal ECoG (channels x seconds at
    raw_sf) with a passthrough audio track, in the npz layout."""
    paths = []
    for block in (1, 2):
        path = os.path.join(raw_dir, "Sub1", f"HS1-B{block}")
        os.makedirs(path)
        ecog = rng.standard_normal((channels, int(seconds * raw_sf)), dtype=np.float32)
        audio = rng.standard_normal((1, int(seconds * AUDIO_SF)), dtype=np.float32)
        np.savez(os.path.join(path, "raw.npz"), ecog=ecog, audio=audio,
                 ecog_sf=raw_sf, audio_sf=AUDIO_SF)
        paths.append(path)
    return paths


def stage_config(raw_dir: str, out_dir: str) -> dict:
    return {"preprocess": {"module": "preprocess_main", "params": {
        "pipeline": {"module": "preprocess.pipelines.subject_block", "params": {
            "subject_dirs": ["Sub1"], "subject_ids": [1], "figures": False}},
        "io": {"module": "preprocess.io.npz_blocks",
               "params": {"root_dir": raw_dir, "output_dir": out_dir}},
        "preprocessor": {"module": "preprocess.preprocessor"},
        "modalities": {
            "ecog": {"type": "signal", "preprocessing": {"steps": PRE_STEPS}},
            "audio": {"type": "signal"},
        },
    }}}


def scipy_chain(x: np.ndarray, raw_sf: float) -> np.ndarray:
    """The example chain in SciPy/numpy float64, written independently of
    the port: resample_poly, the Gaussian-bank Hilbert envelope one bank at
    a time over the full length, sosfiltfilt, the interval z-score."""
    import scipy.signal as sps
    from fractions import Fraction

    num = int(x.shape[1] * PRE_TARGET / raw_sf)
    fr = (Fraction(PRE_TARGET) / Fraction(raw_sf)).limit_denominator(10_000)
    ds = sps.resample_poly(x.astype(np.float64), fr.numerator, fr.denominator,
                           axis=1)[:, :num]
    n = ds.shape[1]
    # Centers 0.018 Hz * 2**(k/7) in [70, 150) Hz; sigma sqrt(2)*0.39*sqrt(fc).
    centers = 0.018 * 2.0 ** (np.arange(120) / 7.0)
    centers = centers[(centers >= 70.0) & (centers < 150.0)]
    freqs = np.fft.fftfreq(n, d=1.0 / PRE_TARGET)
    mult = np.zeros(n)
    mult[0] = 1.0
    mult[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        mult[n // 2] = 1.0
    spec = np.fft.fft(ds, axis=1)
    env = np.zeros_like(ds)
    for fc in centers:
        k = np.exp(-0.5 * ((freqs - fc) / (np.sqrt(2.0) * 0.39 * np.sqrt(fc))) ** 2)
        k[0] = 0.0
        env += np.abs(np.fft.ifft(spec * (k * mult), axis=1))
    env /= len(centers)
    sos = sps.butter(4, [0.3, 100.0], btype="bandpass", fs=PRE_TARGET, output="sos")
    sig = np.concatenate([env, sps.sosfiltfilt(sos, ds, axis=1)], axis=0)
    ref = sig[:, : int(25 * PRE_TARGET)]
    return (sig - ref.mean(axis=1, keepdims=True)) / ref.std(axis=1, keepdims=True)


def preprocess_times(x: np.ndarray, raw_sf: float, card: str) -> None:
    """Times of the chain on the card: preprocess_signal on a device tensor
    (median of 5 wall times after a warm-up) and the device time inside it
    (torch.profiler), so the card's busy share; each step's time between
    CUDA events (median of 5, host stalls included) and its device time;
    the top device operations of one call."""
    from argparse import Namespace

    import torch

    from decode_tonal_langauge_tpu_torch import registry
    from decode_tonal_langauge_tpu_torch._timing import device_events
    from decode_tonal_langauge_tpu_torch.preprocess import preprocessor

    def device_ms(fn):
        rows = device_events(fn, runs=5)
        check(rows, "torch.profiler saw no device time in the preprocess chain")
        return sum(r[0] for r in rows), rows

    xd = torch.from_numpy(x).cuda()

    def call():
        return preprocessor.preprocess_signal(
            xd, PRE_STEPS, Namespace(signal_freq=raw_sf), device="cuda")[0]

    call()  # warm-up: cuFFT plans, cuDNN algorithm choice
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    torch.cuda.reset_peak_memory_stats()
    busy_ms, rows = device_ms(call)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    params = Namespace(signal_freq=raw_sf)
    preprocessor._apply_step_params(PRE_STEPS, params)
    steps, y = {}, xd
    for step in PRE_STEPS:
        module = registry.resolve(step["module"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        runs = []
        for _ in range(5):
            p = Namespace(**vars(params))
            start.record()
            out = module.run(y, p)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        dev_ms, _ = device_ms(lambda: module.run(y, Namespace(**vars(params))))
        steps[step["module"].split(".")[-1]] = (float(np.median(runs)), dev_ms)
        y, params = out, p

    print(f"preprocess {raw_sf} Hz: preprocess_signal {PRE_SECONDS / (wall_ms / 1e3):.1f} "
          f"recording-s/s ({wall_ms:.2f} ms, median of 5), {busy_ms:.3f} ms of it "
          f"device work ({100 * busy_ms / wall_ms:.1f}% busy), peak "
          f"{peak_mib:.0f} MiB allocated [{card}]")
    print("  steps, ms between CUDA events (median of 5) / device ms (torch.profiler): "
          + ", ".join(f"{k} {ev:.3f} / {dv:.3f}" for k, (ev, dv) in steps.items())
          + f" [{card}]")
    for ms, n, name in rows[:8]:
        print(f"    {ms:8.4f} ms  x{n:<5g} {name[:100]}")


def preprocess_phase(card: str) -> None:
    """The preprocess stage through ``preprocess.main.run`` at both rates:
    two blocks each, files and shapes checked, the card's output held
    against the port on the CPU (rtol/atol 1e-3) and against the SciPy
    chain (correlation >= 0.99 outside the first and last 5 s, the gate of
    ``bench.py``), then timed."""
    from argparse import Namespace

    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.preprocess import main as preprocess_main
    from decode_tonal_langauge_tpu_torch.preprocess import preprocessor

    rng = np.random.default_rng(0)
    for raw_sf in PRE_RATES:
        with tempfile.TemporaryDirectory() as root:
            raw_dir = os.path.join(root, "raw")
            blocks = write_blocks(raw_dir, raw_sf, PRE_CHANNELS, PRE_SECONDS, rng)
            cuda_iir.LAUNCHES = 0
            t0 = time.perf_counter()
            setup_dir = preprocess_main.run(
                stage_config(raw_dir, os.path.join(root, "out")))
            stage_s = time.perf_counter() - t0
            k1 = cuda_iir.LAUNCHES
            t_raw = int(PRE_SECONDS * raw_sf)
            n_out = int(t_raw * PRE_TARGET / raw_sf)
            sub = os.path.join(setup_dir, "subject_1")
            for block in (1, 2):
                ecog = np.load(os.path.join(sub, f"B{block}_ecog.npz"))
                audio = np.load(os.path.join(sub, f"B{block}_audio.npz"))
                check(float(ecog["sf"]) == PRE_TARGET and ecog["data"].shape
                      == (2 * PRE_CHANNELS, n_out), f"B{block}_ecog: sf {ecog['sf']}, "
                      f"shape {ecog['data'].shape} at {raw_sf} Hz")
                check(np.isfinite(ecog["data"]).all(), f"B{block}_ecog: non-finite")
                check(float(audio["sf"]) == AUDIO_SF and audio["data"].shape
                      == (1, int(PRE_SECONDS * AUDIO_SF)), f"B{block}_audio: wrong")

            x = np.load(os.path.join(blocks[0], "raw.npz"))["ecog"]
            got = np.load(os.path.join(sub, "B1_ecog.npz"))["data"]
            cpu, _ = preprocessor.preprocess_signal(
                x, PRE_STEPS, Namespace(signal_freq=raw_sf), device="cpu")
            cpu = cpu.numpy()
            err = np.abs(got - cpu).max()
            check(np.allclose(got, cpu, rtol=1e-3, atol=1e-3),
                  f"preprocess {raw_sf} Hz: card vs cpu max abs diff {err}")
            edge = 5 * PRE_TARGET
            ref = scipy_chain(x, raw_sf)
            corr = float(np.corrcoef(got[:, edge:-edge].ravel(),
                                     ref[:, edge:-edge].ravel())[0, 1])
            check(np.isfinite(corr) and corr >= 0.99,
                  f"preprocess {raw_sf} Hz: correlation with SciPy {corr}")
            print(f"preprocess stage {raw_sf} Hz, 2 blocks of {PRE_CHANNELS} x "
                  f"{t_raw}: {stage_s:.2f} s wall (files included), out "
                  f"{got.shape}, card vs cpu max abs diff {err:.3g}, corr with "
                  f"SciPy {corr:.5f}, K1 launches {k1} [{card}]")
            preprocess_times(x, raw_sf, card)


TRAIN_TRIALS, TRAIN_CHANNELS, TRAIN_LENGTH, N_TONES, N_SYLLS = 320, 6, 200, 4, 8
TRAIN_BATCH, TRAIN_LR = 32, 5e-4
# Card vs CPU: from the same seeded weights on the same batch, two NAdam
# steps in float32 on the card and on the CPU. The losses of the two agree
# within STEP_LOSS_TOL. The first gradient and the weights after two steps
# are held by how far each float32 run lies from a float64 twin on the card
# that follows the same branch (relative L2 distance, per tensor): the
# card's lies no farther than the CPU's, or within F64_FLOOR. The twin
# replays the float32 run's max-pool choices and leaky-ReLU sides
# (``BranchTape``): a free float64 run may land a near-tie on the other
# side, and then every gradient below it jumps (one max-pool window
# routed otherwise put a CNN's early gradients ~1.5e-3 from float64; one
# leaky ReLU input on the other side of zero put SynthesisFull's ~2e-4),
# and NAdam's first step, ~lr times the sign of each gradient element,
# carries such jumps into the weights. So the distances measure rounding
# alone. One effect is left: an element whose gradient, at either step, lies
# within rounding of zero takes NAdam's ~lr step in either direction (one
# conv3a.bias element put the CNN-RNN's card weights 8e-4 from its twin),
# and one within ~eps of zero takes a step proportional to its gradient,
# rounding noise and all. As in the tier-1 tests, the weights' distances
# leave out the elements whose gradient, at either step, lies more than
# UNRESOLVED (1%) of itself from the twin's; those are held to MAX_STEPS
# (3.5) lr, two steps of at most ~1.5 lr each. The floor, 1e-4, is a fifth of TF32's unit roundoff (4.9e-4): a
# control run, the same two steps on the card with TF32 allowed in cuDNN
# and cuBLAS, held to its own twin, must fail this rule, or the rule could
# not tell float32 from TF32.
STEP_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
F64_FLOOR = 1e-4
UNRESOLVED, MAX_STEPS = 1e-2, 3.5


def write_subject(root: str, rng) -> dict:
    """A seeded synthetic subject at the paper's widths: ``ecog`` (320, 6,
    200) with a tone contour on channels 0-2 and a syllable contour on
    3-5 over unit noise, 4 tones and 8 syllables; every channel is
    discriminative for both targets."""
    tone = rng.integers(0, N_TONES, TRAIN_TRIALS)
    syll = rng.integers(0, N_SYLLS, TRAIN_TRIALS)
    t = np.linspace(0.0, 1.0, TRAIN_LENGTH, dtype=np.float32)
    tone_shapes = np.stack([np.sin(np.pi * (k + 1) * t) for k in range(N_TONES)])
    syll_shapes = np.stack([np.cos(np.pi * (k + 1) * t + k) for k in range(N_SYLLS)])
    ecog = rng.standard_normal((TRAIN_TRIALS, TRAIN_CHANNELS, TRAIN_LENGTH)).astype(np.float32)
    ecog[:, :3] += tone_shapes[tone][:, None, :]
    ecog[:, 3:] += syll_shapes[syll][:, None, :]
    dirs = {k: os.path.join(root, k) for k in ("samples", "channels", "logs")}
    for d in dirs.values():
        os.makedirs(d)
    np.savez(os.path.join(dirs["samples"], "subject_1.npz"), ecog=ecog, ecog_sf=400.0,
             tone=tone, syllable=syll)
    chans = list(range(TRAIN_CHANNELS))
    selections = {"active_channels": chans, "tone_discriminative": chans,
                  "syllable_discriminative": chans}
    with open(os.path.join(dirs["channels"], "subject_1.json"), "w") as f:
        json.dump(selections, f)
    return {"dirs": dirs, "ecog": ecog, "selections": selections}


def training_config(dirs: dict) -> dict:
    """The paper's pairing: CNN for syllables, CNN-RNN (lstm_dim 800) for
    tones through ``model.per_target``; 2 seeds, batch 32, 3 epochs."""
    return {
        "model": {
            "model": "models.deep_classifiers.CNNClassifier", "model_name": "CNN",
            "model_kwargs": {},
            "per_target": {"tone": {"model": "models.deep_classifiers.CNNRNNClassifier",
                                    "model_kwargs": {"lstm_dim": 800}}},
        },
        "training": {"module": "train_classifier", "params": {
            "io": {"log_dir": dirs["logs"], "sample_dir": dirs["samples"],
                   "channel_selection_dir": dirs["channels"]},
            "experiment": {"targets": ["syllable", "tone"], "features": "ecog",
                           "separate_models": True, "seed": 42, "repeat": 2,
                           "verbose": 0},
            "training": {"train_ratio": 0.7, "vali_ratio": 0.1, "test_ratio": 0.2,
                         "batch_size": TRAIN_BATCH, "epochs": 3, "lr": TRAIN_LR,
                         "patience": 60, "weight_decay": 0.01, "standardize": True,
                         "save_checkpoints": True},
        }},
        "evaluation": {"metrics": ["accuracy", "f1_score"],
                       "metric_aggregates": ["mean", "std"]},
    }


def read_csv(path: str) -> list:
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def check_stage_outputs(log_dir: str, seeds) -> None:
    """results.csv rows, class counts, checkpoints and per-seed histories,
    every number finite."""
    rows = read_csv(os.path.join(log_dir, "results.csv"))
    check([r["target"] for r in rows] == ["syllable, tone", "syllable", "tone"],
          f"results.csv targets {[r['target'] for r in rows]}")
    for r in rows:
        for key in ("accuracy_mean", "accuracy_std", "f1_score_mean", "f1_score_std"):
            check(np.isfinite(float(r[key])), f"results.csv {r['target']} {key} = {r[key]}")
    with open(os.path.join(log_dir, "n_classes_subject_1.json")) as f:
        check(json.load(f) == {"syllable": N_SYLLS, "tone": N_TONES},
              "n_classes_subject_1.json")
    ckpts = sorted(os.listdir(os.path.join(log_dir, "model_checkpoints")))
    want = sorted([f"syllable_CNN_subject_1_seed_{s}" for s in seeds]
                  + [f"tone_CNNRNNClassifier_subject_1_seed_{s}" for s in seeds])
    check(ckpts == want, f"checkpoints {ckpts}")
    for target in ("syllable", "tone"):
        for seed in seeds:
            hist = read_csv(os.path.join(log_dir, f"{target}_csv", "subject_1",
                                         f"seed_{seed}", "metrics.csv"))
            check(len(hist) == 3 and all(np.isfinite(float(v)) for r in hist
                                         for v in r.values()),
                  f"{target} seed {seed} metrics.csv: {hist}")


def round_trip(log_dir: str, subject: dict, fits: dict, seeds, device: str) -> None:
    """The stage's checkpoints through the serving path on the card: on
    each seed's test trials, decoded in batches of the trainer's size, the
    ids equal the trainer's test predictions."""
    from decode_tonal_langauge_tpu_torch import serving
    from decode_tonal_langauge_tpu_torch.data.splits import split_indices

    dataset = {"n_tones": N_TONES, "n_syllables": N_SYLLS,
               "tone_dynamic_mapping": {str(k): [0.0] for k in range(N_TONES)}}
    ckpt = os.path.join(log_dir, "model_checkpoints", "{}_subject_1_seed_{}")
    for seed in seeds:
        _, _, te = split_indices(TRAIN_TRIALS, [0.7, 0.1, 0.2], seed=int(seed))
        decoder = serving.load_decoder(
            subject["selections"], dataset, TRAIN_LENGTH,
            "CNNRNN", ckpt.format("tone_CNNRNNClassifier", seed),
            "CNN", ckpt.format("syllable_CNN", seed),
            tone_model_kwargs={"lstm_dim": 800}, device=device)
        ecog = subject["ecog"][te]
        outs = [decoder.decode(ecog[lo:lo + TRAIN_BATCH], subject["selections"])
                for lo in range(0, len(te), TRAIN_BATCH)]
        for key in ("tone", "syllable"):
            got = np.concatenate([o[key] for o in outs])
            want = fits[key][int(seed)]
            check(np.array_equal(got, want),
                  f"round trip seed {seed}: served {key} ids differ from the trainer's "
                  f"on {int((got != want).sum())} of {len(te)} test trials")
    print(f"round trip: checkpoints -> serving.load_decoder on the card reproduce the "
          f"trainer's tone and syllable test predictions for seeds {list(seeds)}")


def classifier_loss(model, batch):
    """The classifier trainer's loss: softmax cross-entropy, weighted."""
    from decode_tonal_langauge_tpu_torch.training.trainer import _batch_loss

    return _batch_loss(model(batch[0]), batch[1], batch[2])


class BranchTape:
    """The branch one forward takes through the models' kinks: the element
    each max-pool window picked (``F.max_pool2d``), the larger of the
    stencil's pool phases (``torch.maximum``) and the side of zero of each
    leaky ReLU's input (``F.leaky_relu``), recorded in call order from one
    run and replayed in another. A float64 run that replays a float32
    run's tape computes the exact gradient of the branch that run took, so
    the two differ by rounding alone: where a float32 forward lands a
    near-tie or a near-zero input on the other side than float64 does, the
    gradient below it jumps by far more than rounding (a max-pool routes
    it elsewhere, a leaky ReLU scales it by its slope)."""

    def __init__(self) -> None:
        self.decisions: list = []
        self.replayed = 0  # decisions replayed so far, across forwards

    @contextlib.contextmanager
    def patched(self, replay: bool):
        import torch
        import torch.nn.functional as F

        saved = F.leaky_relu, F.max_pool2d, torch.maximum

        def decision(record, like):
            if replay:
                self.replayed += 1
                return self.decisions[self.replayed - 1].to(like.device)
            self.decisions.append(record())
            return self.decisions[-1]

        def leaky_relu(x, negative_slope=0.01, inplace=False):
            mask = decision(lambda: (x > 0).detach(), x)
            return torch.where(mask, x, x * negative_slope)

        def max_pool2d(x, kernel_size, stride=None, *args, **kwargs):
            idx = decision(lambda: saved[1](x.detach(), kernel_size, stride,
                                            return_indices=True)[1], x)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        def maximum(a, b):
            return torch.where(decision(lambda: (a >= b).detach(), a), a, b)

        F.leaky_relu, F.max_pool2d, torch.maximum = leaky_relu, max_pool2d, maximum
        try:
            yield
        finally:
            F.leaky_relu, F.max_pool2d, torch.maximum = saved


def classifier_loss(model, batch):
    """The classifier trainer's loss: softmax cross-entropy, weighted."""
    from decode_tonal_langauge_tpu_torch.training.trainer import _batch_loss

    return _batch_loss(model(batch[0]), batch[1], batch[2])


def two_steps(model, batch, precision, loss, tape=None, replay=False, **opt) -> dict:
    """Two NAdam steps (``opt`` its arguments) of ``loss(model, batch)``
    in the model's own dtype, the forward and backward inside
    ``precision()``, recording the branch into ``tape`` (or, with
    ``replay``, following the branch recorded there): the first gradient
    (float64), both steps' gradients (float32), the losses and the final
    weights."""
    import torch

    from decode_tonal_langauge_tpu_torch.training.optim import NAdam

    names, weights = zip(*model.named_parameters())
    optimizer = NAdam(weights, **opt)
    model.train()
    first, losses, steps = None, [], []
    for _ in range(2):
        branch = tape.patched(replay) if tape is not None else contextlib.nullcontext()
        with precision(), branch:
            value = loss(model, batch)
            grads = torch.autograd.grad(value, weights)
        first = first or {k: g.cpu().double() for k, g in zip(names, grads)}
        steps.append({k: g.float().cpu() for k, g in zip(names, grads)})
        optimizer.step(grads)
        losses.append(value.item())
    end = {k: v.detach().cpu().double() for k, v in zip(names, weights)}
    return {"grads": first, "steps": steps, "losses": losses, "end": end}


def unresolved(run: dict, twin: dict) -> dict:
    """Per tensor, the elements whose gradient, at either step, lies more
    than UNRESOLVED of its float64 twin's value away from it: those
    within rounding of zero."""
    return {k: (((run["steps"][0][k] - twin["steps"][0][k]).abs()
                 > UNRESOLVED * twin["steps"][0][k].abs())
                | ((run["steps"][1][k] - twin["steps"][1][k]).abs()
                   > UNRESOLVED * twin["steps"][1][k].abs()))
            for k in run["steps"][0]}


@contextlib.contextmanager
def tf32_allowed():
    """cuDNN convolutions and cuBLAS matmuls in TF32, for the control run."""
    import torch

    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=True):
            yield
    finally:
        matmul.allow_tf32 = before


def distance(run: dict, exact: dict, key: str, skip=None) -> dict:
    """Relative L2 distance of each tensor of ``run[key]`` from a float64
    run's, leaving out the elements ``skip`` marks."""
    out = {}
    for k, v in run[key].items():
        ref = exact[key][k]
        if skip is not None:
            v, ref = v[~skip[k]], ref[~skip[k]]
        out[k] = (v - ref).norm().item() / max(ref.norm().item(), 1e-30)
    return out


def parity_faults(run: str, runs: dict, lr: float) -> list:
    """Where ``runs[run]`` breaks the card-vs-CPU rule (see STEP_LOSS_TOL):
    the losses against the CPU's, then each tensor of the first gradient
    and of the weights after two steps, held by its distance from its own
    float64 twin (``runs[run + "64"]``) against the CPU's from its twin;
    the weights of elements whose gradient float32 cannot resolve held to
    MAX_STEPS * lr instead; empty when it holds."""
    faults = []
    if not np.allclose(runs[run]["losses"], runs["cpu"]["losses"], **STEP_LOSS_TOL):
        faults.append(f"losses {runs[run]['losses']} vs cpu {runs['cpu']['losses']}")
    flips = {r: unresolved(runs[r], runs[r + "64"]) for r in (run, "cpu")}
    for key, what in (("grads", "first gradient"), ("end", "weights after 2 steps")):
        skip = {r: flips[r] if key == "end" else None for r in (run, "cpu")}
        mine = distance(runs[run], runs[run + "64"], key, skip[run])
        cpus = distance(runs["cpu"], runs["cpu64"], key, skip["cpu"])
        faults += [f"{what} {k}: {mine[k]:.3g} from float64, cpu {cpus[k]:.3g}"
                   for k in mine if mine[k] > max(cpus[k], F64_FLOOR)]
    for k, flipped in flips[run].items():
        off = (runs[run]["end"][k] - runs[run + "64"]["end"][k]).abs()[flipped]
        if off.numel() and off.max().item() > MAX_STEPS * lr:
            faults.append(f"weights after 2 steps {k}: an element of unresolved gradient "
                          f"{off.max().item():.3g} from float64, over {MAX_STEPS} lr")
    return faults


def held_step_parity(card: str, name: str, model, batch, device: str, loss, **opt) -> None:
    """Two NAdam steps of ``model`` from the same weights on ``batch``
    (CPU tensors) in float32 on the card and on the CPU, and the TF32
    control on the card, each with a float64 twin on the card that
    follows its branch (``BranchTape``), plus a float64 run on its own
    branch for comparison; fails unless the card keeps the rule of
    STEP_LOSS_TOL and the control breaks it."""
    import copy

    import torch

    from decode_tonal_langauge_tpu_torch.runtime.device import exact_f32

    def run(dev, dtype, precision, **tape):
        on_dev = tuple(t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for t in batch)
        return two_steps(copy.deepcopy(model).to(dev, dtype), on_dev, precision, loss,
                         **tape, **opt)

    runs = {}
    for key, dev, precision in (("card", device, exact_f32), ("cpu", "cpu", exact_f32),
                                ("tf32", device, tf32_allowed)):
        if key == "tf32" and device != "cuda":
            continue  # TF32 exists on the card only
        tape = BranchTape()
        runs[key] = run(dev, torch.float32, precision, tape=tape)
        runs[key + "64"] = run(device, torch.float64, exact_f32, tape=tape, replay=True)
    free = run(device, torch.float64, exact_f32)  # float64 on its own branch
    f32_runs = [k for k in ("card", "cpu", "tf32") if k in runs]
    print(f"{name} card vs cpu at batch {batch[0].shape[0]}, 2 NAdam steps: losses "
          f"{runs['card']['losses']} vs {runs['cpu']['losses']} (float64 {free['losses']}"
          + (f", TF32 control {runs['tf32']['losses']}" if "tf32" in runs else "")
          + f") [{card}]")
    for key, what in (("grads", "first gradient"), ("end", "weights after 2 steps")):
        dist = {r: distance(runs[r], runs[r + "64"], key,
                            unresolved(runs[r], runs[r + "64"]) if key == "end" else None)
                for r in f32_runs}
        print(f"  {what}, relative L2 distance from the float64 twin on its branch "
              f"({' / '.join(dist)}): "
              + ", ".join(f"{k} " + "/".join(f"{d[k]:.2g}" for d in dist.values())
                          for k in dist["card"]))
        loose = {r: distance(runs[r], free, key) for r in ("card", "cpu")}
        worst = {r: max(d.items(), key=lambda kv: kv[1]) for r, d in loose.items()}
        print(f"    from float64 on its own branch, largest: "
              + ", ".join(f"{r} {k} {v:.2g}" for r, (k, v) in worst.items()))
    exempt = {r: sum(int(m.sum()) for m in unresolved(runs[r], runs[r + "64"]).values())
              for r in f32_runs}
    print(f"  elements whose gradient lies over {UNRESOLVED:g} of itself from the twin's, "
          f"left out of the weights' distances (held to {MAX_STEPS} lr): "
          + ", ".join(f"{r} {n}" for r, n in exempt.items()))
    faults = parity_faults("card", runs, opt["learning_rate"])
    check(not faults, f"{name}: the card breaks the step rule: {'; '.join(faults)}")
    if "tf32" in runs:
        control = parity_faults("tf32", runs, opt["learning_rate"])
        print(f"  TF32 control breaks the rule on {len(control)} of "
              f"{1 + 2 * len(runs['card']['grads'])} counts, as it must: "
              f"{'; '.join(control[:4])}")
        check(bool(control), f"{name}: the TF32 control passes the step rule, "
              "which therefore cannot tell float32 from TF32")


def step_parity(card: str, device: str) -> dict:
    """Card vs CPU: the full-width CNN and CNN-RNN (dropout 0) from the
    same seeded weights on one batch of 32 (``held_step_parity``).
    Returns card trainers and the batch for the timings."""
    import copy

    import torch

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

    rng = np.random.default_rng(1)
    x = rng.standard_normal((TRAIN_BATCH, TRAIN_CHANNELS, TRAIN_LENGTH)).astype(np.float32)
    out = {}
    for name, n_classes, kwargs in (("CNN", N_SYLLS, {"dropout_rate": 0.0}),
                                    ("CNNRNN", N_TONES, {"lstm_dim": 800, "dropout": 0.0})):
        y = torch.from_numpy(rng.integers(0, n_classes, TRAIN_BATCH))
        model = init_params(get_classifier_by_name(
            name, n_classes, TRAIN_CHANNELS, TRAIN_LENGTH, kwargs), seed=3)
        held_step_parity(card, name, model, (torch.from_numpy(x), y, torch.ones(TRAIN_BATCH)),
                         device, classifier_loss, learning_rate=TRAIN_LR, weight_decay=0.01)
        trainer = ClassifierTrainer(copy.deepcopy(model), n_classes, learning_rate=TRAIN_LR,
                                    weight_decay=0.01, batch_size=TRAIN_BATCH, seed=3,
                                    device=device)
        trainer.init()
        out[name] = (trainer, (torch.from_numpy(x).to(device), y.to(device),
                               torch.ones(TRAIN_BATCH, device=device)))
    return out


def step_profile(step) -> dict:
    """One train step's median wall time (host clock around synchronize,
    10 steps after 3 warm-ups), its peak device memory over one step, and
    its device work from torch.profiler: busy ms, operations, top rows."""
    import torch

    from decode_tonal_langauge_tpu_torch._timing import device_events

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    rows = device_events(step, runs=3)
    return {"wall_ms": float(np.median(walls)) * 1e3, "peak_mib": peak, "rows": rows,
            "busy_ms": sum(r[0] for r in rows), "ops": sum(r[1] for r in rows)}


def print_step(card: str, name: str, n: int, prof: dict, top: int = 8) -> None:
    wall = prof["wall_ms"]
    print(f"{name} train step, batch {n}: {wall:.2f} ms (median of 10), "
          f"{n / (wall / 1e3):.1f} trials/s; device work {prof['busy_ms']:.3f} ms "
          f"({100 * prof['busy_ms'] / wall:.1f}% busy), {prof['ops']:.0f} device operations "
          f"a step, peak {prof['peak_mib']:.0f} MiB [{card}]")
    for ms, count, op in prof["rows"][:top]:
        print(f"    {ms:8.4f} ms  x{count:<6g} {op[:100]}")


def train_step_times(card: str, trainers: dict) -> None:
    """Median train-step wall time and trials/s per model at its batch;
    the device work of one step from torch.profiler: busy share,
    launches, top operations (``step_profile``)."""
    for name, (trainer, batch) in trainers.items():
        prof = step_profile(lambda: trainer.train_step(*batch))  # noqa: B023
        check(prof["rows"], f"torch.profiler saw no device time in a {name} train step")
        print_step(card, name, batch[0].shape[0], prof)


def training_phase(card: str, device: str = "cuda") -> None:
    """The classifier-training stage through ``train_classifier.run`` on
    the card at the paper's widths, its outputs checked, the checkpoints
    served back, card vs CPU step parity, and the step timings (card
    only: ``device="cpu"`` rehearses the rest on a machine without one)."""
    import torch

    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.training import classifier_pipeline, train_classifier
    from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream

    fits = {}
    fit_all = classifier_pipeline._fit_eval_all_seeds

    def recording(*args, target_str=None, **kwargs):  # each target's test predictions
        results = fit_all(*args, target_str=target_str, **kwargs)
        fits[target_str] = {r.seed: r.test_preds for r in results}
        return results

    with tempfile.TemporaryDirectory() as root:
        subject = write_subject(root, np.random.default_rng(0))
        seeds = [int(s) for s in seed_stream(42, 2)]
        cuda_iir.LAUNCHES = 0
        on_card = device == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        classifier_pipeline._fit_eval_all_seeds = recording
        try:
            t0 = time.perf_counter()
            log_dir = train_classifier.run(training_config(subject["dirs"]),
                                           device=None if on_card else device)
            stage_s = time.perf_counter() - t0
        finally:
            classifier_pipeline._fit_eval_all_seeds = fit_all
        check(sorted(fits) == ["syllable", "tone"], f"fits recorded for {sorted(fits)}")
        peak_mib = torch.cuda.max_memory_allocated() / 2**20 if on_card else float("nan")
        check_stage_outputs(log_dir, seeds)
        rows = read_csv(os.path.join(log_dir, "results.csv"))
        print(f"training stage, 2 targets x 2 seeds x 3 epochs, {TRAIN_TRIALS} trials of "
              f"{TRAIN_CHANNELS} x {TRAIN_LENGTH}: {stage_s:.2f} s wall (files included), "
              f"peak {peak_mib:.0f} MiB allocated; test accuracy "
              + ", ".join(f"{r['target']} {float(r['accuracy_mean']):.3f}" for r in rows)
              + f" [{card}]")
        round_trip(log_dir, subject, fits, seeds, device)
    trainers = step_parity(card, device)
    if on_card:
        train_step_times(card, trainers)
    print(f"K1 launches during the training phase: {cuda_iir.LAUNCHES}")
    check(cuda_iir.LAUNCHES == 0, "K1 launched during the training phase")


# The synthesizer phase at the paper's SynthesisFull widths (bench.py:371-463 and
# 723-795): 96 trials of 40 non-discriminative + 6 tone + 6 syllable channels x 200
# samples, 100-step label dynamics, mel 128 x 20 (0.4 s of audio at 24,414 Hz, hop
# 512), batch 8. A rehearsal size runs the same code on a CPU.
SYN_FULL = dict(trials=96, non=40, cls=6, n_dyn=100, n_mels=128)
SYN_REHEARSAL = dict(trials=24, non=5, cls=6, n_dyn=10, n_mels=16)
SYN_LENGTH, SYN_BATCH, SYN_EPOCHS, SYN_SR, SYN_AUDIO = 200, 8, 3, 24414, 9765
SYN_LR, SYN_DECAY = 5e-4, 0.004


def data_path_phase(device: str) -> None:
    """A synthetic subject (the port's ``data/synthetic``) through the
    port's preprocess stage and ``extract_samples.run``: the sample npz's
    keys, shapes and labels."""
    from decode_tonal_langauge_tpu_torch.data import extract_samples, synthetic
    from decode_tonal_langauge_tpu_torch.preprocess import main as preprocess_main

    spec = synthetic.SyntheticSpec(n_channels=16, n_blocks=2, trials_per_block=8)
    on = None if device == "cuda" else device
    with tempfile.TemporaryDirectory() as root:
        raw = os.path.join(root, "raw")
        blocks = synthetic.write_subject(raw, 1, spec)
        steps = [{"module": "preprocess.downsample", "params": {"downsample_freq": 400}},
                 {"module": "preprocess.frequency_filter", "params": {"bands": [
                     {"method": "hilbert", "params": {"freq_ranges": [70, 150],
                                                      "envelope": True}}]}},
                 {"module": "preprocess.zscore_rereference",
                  "params": {"rereference_interval": [0.0, 5.0]}}]
        cfg = stage_config(raw, os.path.join(root, "processed"))
        cfg["preprocess"]["params"]["modalities"]["ecog"]["preprocessing"]["steps"] = steps
        t0 = time.perf_counter()
        setup_dir = preprocess_main.run(cfg, device=on)
        collect = {"sample_collection": {"module": "extract_samples", "params": {
            "io": {"output_dir": os.path.join(root, "samples"), "textgrid_root": raw,
                   "recording_dir": setup_dir, "figures": False},
            "subjects": {1: {"start_offset": 0.2, "sample_length": 1.0,
                             "rest_period": [0.0, 5.0],
                             "textgrid_dir": "annotations/subject_1",
                             "tier_list": ["success"]}},
            "settings": {"syllable_identifiers": list(spec.syllables)},
        }}}
        out_dir = extract_samples.run(collect, device=on)
        wall = time.perf_counter() - t0
        data = np.load(os.path.join(out_dir, "subject_1.npz"))
        events = [ev for b in sorted(blocks) for ev in blocks[b].events]
        n = len(events)
        check(sorted(data.files) == sorted(["ecog", "ecog_sf", "audio", "audio_sf",
                                            "syllable", "tone", "ecog_rest"]),
              f"sample npz keys {data.files}")
        check(data["ecog"].shape == (n, spec.n_channels, 400)
              and data["audio"].shape == (n, int(spec.audio_sf))
              and data["ecog_rest"].shape[1:] == (spec.n_channels, 400)
              and float(data["ecog_sf"]) == 400.0,
              f"sample npz shapes ecog {data['ecog'].shape}, audio {data['audio'].shape}, "
              f"rest {data['ecog_rest'].shape}, sf {data['ecog_sf']}")
        check(np.array_equal(data["tone"], [ev["tone"] - 1 for ev in events])
              and np.array_equal(data["syllable"],
                                 [spec.syllables.index(ev["syllable"]) for ev in events]),
              "sample npz labels differ from the synthetic events")
        check(all(np.isfinite(data[k]).all() for k in ("ecog", "audio", "ecog_rest")),
              "sample npz: non-finite values")
    print(f"data path: synthetic subject -> preprocess -> extract_samples, {n} trials, "
          f"ecog {data['ecog'].shape}, audio {data['audio'].shape}, rest "
          f"{data['ecog_rest'].shape}, labels equal the events ({wall:.2f} s wall)")


def write_synthesis_world(root: str, sz: dict) -> dict:
    """A seeded sample npz (tone channels 0-5, syllable channels 6-11, the
    rest non-discriminative; tone-pitched audio), its channel and config
    JSON, and seeded CNN-RNN tone and CNN syllable checkpoints with
    scalers."""
    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.runtime.checkpoint import save_checkpoint

    rng = np.random.default_rng(5)
    n, cls, n_ch = sz["trials"], sz["cls"], 2 * sz["cls"] + sz["non"]
    tone, syll = rng.integers(0, N_TONES, n), rng.integers(0, N_SYLLS, n)
    t = np.linspace(0.0, 1.0, SYN_LENGTH)
    ecog = rng.standard_normal((n, n_ch, SYN_LENGTH)).astype(np.float32)
    ecog[:, :cls] += np.sin(np.pi * (tone[:, None] + 1) * t)[:, None, :]
    ecog[:, cls:2 * cls] += np.cos(np.pi * (syll[:, None] + 1) * t)[:, None, :]
    ta = np.arange(SYN_AUDIO) / SYN_SR
    audio = (np.hanning(SYN_AUDIO) * np.sin(2 * np.pi * (150.0 + 40.0 * tone[:, None]) * ta)
             + 0.05 * rng.standard_normal((n, SYN_AUDIO))).astype(np.float32)
    paths = {k: os.path.join(root, f) for k, f in (
        ("sample", "subject_1.npz"), ("channels", "channels.json"), ("config", "config.json"))}
    np.savez(paths["sample"], ecog=ecog, ecog_sf=400.0, audio=audio, audio_sf=float(SYN_SR),
             tone=tone, syllable=syll)
    channels = {"active_channels": list(range(n_ch)),
                "tone_discriminative": list(range(cls)),
                "syllable_discriminative": list(range(cls, 2 * cls))}
    config = {"mel_kwargs": {"n_mels": sz["n_mels"], "n_fft": 2048, "hop_length": 512},
              "tone_dynamic_mapping": {str(k): list(np.linspace(k / 4, 1 - k / 4, sz["n_dyn"]))
                                       for k in range(N_TONES)},
              "n_tones": N_TONES, "n_syllables": N_SYLLS}
    for key, obj in (("channels", channels), ("config", config)):
        with open(paths[key], "w") as f:
            json.dump(obj, f)
    for key, name, n_classes, seed in (("tone", "CNNRNN", N_TONES, 7), ("syll", "CNN", N_SYLLS, 8)):
        model = init_params(get_classifier_by_name(name, n_classes, cls, SYN_LENGTH), seed=seed)
        scaler = (0.1 * rng.standard_normal((1, cls, SYN_LENGTH)).astype(np.float32),
                  (rng.random((1, cls, SYN_LENGTH)) + 0.5).astype(np.float32))
        paths[key] = save_checkpoint(os.path.join(root, f"{key}.pt"), model, scaler)
    return {"paths": paths, "channels": channels, "config": config, "ecog": ecog}


def synthesizer_args(paths: dict, out: str, device: str, *extra) -> list:
    """The synthesizer CLI's arguments: SynthesisFull, CNN syllable and
    CNN-RNN tone checkpoints, batch 8, 2 seeds x 3 epochs, checkpoints."""
    args = ["--sample_path", paths["sample"], "--subject_id", "1",
            "--channel_file", paths["channels"], "--config_file", paths["config"],
            "--model_name", "synth_smoke", "--synthesis_model_name", "SynthesisFull",
            "--syllable_model_name", "CNN", "--syllable_model_path", paths["syll"],
            "--tone_model_name", "CNNRNN", "--tone_model_path", paths["tone"],
            "--epochs", str(SYN_EPOCHS), "--batch_size", str(SYN_BATCH), "--repeat", "2",
            "--lr", str(SYN_LR), "--schedule_decay", str(SYN_DECAY), "--verbose", "0",
            "--audio_sampling_rate", str(SYN_SR), "--result_file",
            os.path.join(out, "results.csv"), "--checkpoint_dir", os.path.join(out, "ckpts")]
    if device != "cuda":
        args += ["--device", device]
    return args + list(extra)


def equal_checkpoints(a: str, b: str) -> bool:
    import torch

    from decode_tonal_langauge_tpu_torch.runtime.checkpoint import load_checkpoint

    pa, pb = load_checkpoint(a)[0], load_checkpoint(b)[0]
    return pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)


def synthesis_stage(card: str, device: str, root: str, world: dict, sz: dict) -> dict:
    """``train_synthesizer.run`` at the phase's widths, its files and rows
    checked, ``--evaluate_only`` and a resume (2 epochs, then 3) held to
    the fit. Returns the fits ``fit_eval_seed`` made and the summary."""
    import torch

    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.training import synthesis_trainer
    from decode_tonal_langauge_tpu_torch.training import train_synthesizer as stage
    from decode_tonal_langauge_tpu_torch.utils.audio import audio_to_mel

    paths = world["paths"]
    parse = stage.build_parser().parse_args
    fits, fit_eval = [], synthesis_trainer.fit_eval_seed

    def recording(trainer, *args, **kwargs):  # each seed's trainer, times and results
        t0 = time.perf_counter()
        result = fit_eval(trainer, *args, **kwargs)
        fits.append({"seed": trainer.seed, "s": time.perf_counter() - t0,
                     "n_params": trainer.n_params(), "result": result})
        return result

    on_card = device == "cuda"
    cuda_iir.LAUNCHES = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = os.path.join(root, "fit")
    synthesis_trainer.fit_eval_seed = recording  # the seed loop's per-seed fit
    try:
        t0 = time.perf_counter()
        summary = stage.run(parse(synthesizer_args(
            paths, out, device, "--train_state_dir", os.path.join(out, "states"),
            "--audio_dir", os.path.join(out, "wavs"))))
        stage_s = time.perf_counter() - t0
    finally:
        synthesis_trainer.fit_eval_seed = fit_eval
    peak_mib = torch.cuda.max_memory_allocated() / 2**20 if on_card else float("nan")
    k1 = cuda_iir.LAUNCHES

    seeds = [int(s) for s in np.random.default_rng(42).integers(0, 10000, 2)]
    check(json.loads(summary["seeds"]) == seeds and [f["seed"] for f in fits] == seeds,
          f"seeds {summary['seeds']}, fits {[f['seed'] for f in fits]}")
    names = sorted(f"SynthesisFull_seed_{s}" for s in seeds)
    for sub in ("ckpts", "states"):
        check(sorted(os.listdir(os.path.join(out, sub))) == names,
              f"{sub}: {sorted(os.listdir(os.path.join(out, sub)))}")
    rows = read_csv(os.path.join(out, "results.csv"))
    check(len(rows) == 1 and rows[0]["mcd_all"] == summary["mcd_all"], f"results.csv {rows}")
    n_test = sz["trials"] - int(sz["trials"] * 0.9)
    n_waves = min(10, n_test)
    check(sorted(os.listdir(os.path.join(out, "wavs"))) == sorted(
        f"{tag}_{i}.wav" for tag in ("origin", "recon") for i in range(n_waves)),
        "the stage wrote other WAVs than 2 x n_waves")
    mels = np.stack([audio_to_mel(a, SYN_SR, mel_kwargs=world["config"]["mel_kwargs"],
                                  device=device) for a in np.load(paths["sample"])["audio"]])
    check(mels.shape == (sz["trials"], sz["n_mels"] * 20), f"mels {mels.shape}")
    from decode_tonal_langauge_tpu_torch.data.splits import split_indices
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import compute_mcd

    for f, mcd in zip(fits, json.loads(summary["mcd_all"])):
        history, fit_mcd, recon, origin = f["result"]
        te = split_indices(sz["trials"], [0.9, 0.1], seed=f["seed"])[-1]
        zero = compute_mcd(mels[te], np.zeros_like(mels[te]))
        check(len(history) == SYN_EPOCHS and np.isfinite(history).all()
              and recon.shape == (n_test, mels.shape[1]) and np.isfinite(recon).all()
              and np.array_equal(origin, mels[te]) and fit_mcd == mcd and mcd < zero,
              f"seed {f['seed']}: history {history}, mcd {mcd} (zero predictor {zero}), "
              f"recon {recon.shape}")
    print(f"synthesizer stage, {summary['synthesis_model']} ({summary['model_size']:,} "
          f"parameters), {sz['trials']} trials of {sz['non']} + 2 x {sz['cls']} channels x "
          f"{SYN_LENGTH}, mel {mels.shape[1]}, 2 seeds x {SYN_EPOCHS} epochs at batch "
          f"{SYN_BATCH}: stage {stage_s:.2f} s wall (files, mels, WAVs included), fits "
          + " + ".join(f"{f['s']:.2f}" for f in fits) + f" s (train + evaluate), peak "
          f"{peak_mib:.0f} MiB allocated; test MCD {summary['mcd_all']} (zero predictor "
          f"~{zero:.0f}), mel r {summary['mel_pearson_r_mean']:.4f} [{card}]")
    print(f"K1 launches during the synthesizer stage: {k1}")
    check(k1 == 0, "K1 launched during the synthesizer stage")

    ev = stage.run(parse(synthesizer_args(paths, out, device, "--evaluate_only",
                                          "--result_file", os.path.join(out, "eval.csv"))))
    for key in ("mcd_all", "mel_pearson_r_mean", "model_size", "seeds"):
        check(ev[key] == summary[key], f"--evaluate_only {key}: {ev[key]} vs {summary[key]}")
    print(f"--evaluate_only reproduces each seed's row exactly: mcd_all {ev['mcd_all']}")

    res = os.path.join(root, "resume")
    one = synthesizer_args(paths, res, device, "--train_state_dir", os.path.join(res, "states"))
    one[one.index("--repeat") + 1] = "1"
    two = list(one)
    two[two.index("--epochs") + 1] = "2"
    stage.run(parse(two))
    resumed = stage.run(parse(one + ["--resume"]))
    name = f"SynthesisFull_seed_{seeds[0]}"
    check(json.loads(resumed["mcd_all"])[0] == json.loads(summary["mcd_all"])[0]
          and equal_checkpoints(os.path.join(res, "ckpts", name), os.path.join(out, "ckpts", name)),
          f"resume 2 -> 3 epochs: mcd {resumed['mcd_all']} vs the straight fit's "
          f"{summary['mcd_all']}, or other weights")
    print(f"resume: 2 epochs, then --resume to 3, equal the straight 3-epoch fit of seed "
          f"{seeds[0]} (weights bit for bit, MCD {json.loads(resumed['mcd_all'])[0]})")
    return {"fits": fits, "summary": summary, "out": out, "stage_s": stage_s,
            "peak_mib": peak_mib}


def synthesis_serving(card: str, device: str, world: dict, stage: dict, sz: dict) -> None:
    """The serving CLI loads a synthesizer checkpoint and reports mel_mcd
    and mel_pearson_r on trials with audio; on each seed's test trials,
    decoded in batches of the trainer's size, its mels equal evaluate's
    within rtol/atol 1e-3."""
    from decode_tonal_langauge_tpu_torch import serving
    from decode_tonal_langauge_tpu_torch.data.splits import split_indices

    paths, out = world["paths"], stage["out"]
    ckpt = os.path.join(out, "ckpts", "SynthesisFull_seed_{}")
    seed = stage["fits"][0]["seed"]
    serve_dir = os.path.join(out, "served")
    summary = serving.run(serving.build_parser().parse_args([
        "--sample_path", paths["sample"], "--channel_file", paths["channels"],
        "--config_file", paths["config"], "--tone_model_name", "CNNRNN",
        "--tone_model_path", paths["tone"], "--syllable_model_name", "CNN",
        "--syllable_model_path", paths["syll"], "--synthesis_model_name", "SynthesisFull",
        "--synthesis_model_path", ckpt.format(seed), "--audio_sampling_rate", str(SYN_SR),
        "--output_dir", serve_dir, "--n_wavs", "2", "--device", device]))
    check(summary["n_trials"] == sz["trials"] and np.isfinite(summary["mel_mcd"])
          and np.isfinite(summary["mel_pearson_r"]), f"serving summary {summary}")
    worst = 0.0
    for f in stage["fits"]:
        decoder = serving.load_decoder(
            world["channels"], world["config"], SYN_LENGTH, "CNNRNN", paths["tone"],
            "CNN", paths["syll"], synthesis_model_name="SynthesisFull",
            synthesis_model_path=ckpt.format(f["seed"]), device=device)
        te = split_indices(sz["trials"], [0.9, 0.1], seed=f["seed"])[-1]
        ecog = world["ecog"][te]
        served = np.concatenate([
            decoder.decode(ecog[lo:lo + SYN_BATCH], world["channels"])["mel"]
            for lo in range(0, len(te), SYN_BATCH)])
        recon = f["result"][2]
        worst = max(worst, float(np.abs(served - recon).max()))
        check(np.allclose(served, recon, rtol=1e-3, atol=1e-3),
              f"seed {f['seed']}: served mels vs evaluate's, max abs diff "
              f"{np.abs(served - recon).max()}")
    print(f"serving: the SynthesisFull checkpoint of seed {seed} on all {sz['trials']} "
          f"trials: mel_mcd {summary['mel_mcd']:.4f}, mel_pearson_r "
          f"{summary['mel_pearson_r']:.4f}; served test mels vs evaluate's max abs diff "
          f"{worst:.3g} (both seeds, batches of {SYN_BATCH}) [{card}]")


def synthesis_batch(rng, n: int, sz: dict):
    """A SynthesisTrainer batch: ECoG, label dynamics, mel targets and
    weights (the last row padding)."""
    import torch

    w = np.ones(n, np.float32)
    w[-1] = 0.0
    return tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((n, sz["non"], SYN_LENGTH)).astype(np.float32),
        rng.integers(0, 2, (n, 2, sz["n_dyn"])).astype(np.float32),
        (rng.standard_normal((n, sz["n_mels"] * 20)) * 10 - 40).astype(np.float32), w))


def synthesis_steps(card: str, device: str, world: dict, sz: dict) -> None:
    """The train step timed at batch 8 and 32 (card only), then two NAdam
    steps of SynthesisFull (dropout 0) card vs CPU vs float64 with the
    TF32 control."""
    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import SynthesisTrainer

    rng = np.random.default_rng(11)
    mel_dim = sz["n_mels"] * 20
    batch = lambda n: synthesis_batch(rng, n, sz)  # noqa: E731

    def l1(model, b):
        out = model(b[0], b[1])
        return ((out - b[2]).abs().mean(dim=1) * b[3]).sum() / b[3].sum()

    if device == "cuda":
        classifiers = [init_params(get_classifier_by_name(name, k, sz["cls"], SYN_LENGTH),
                                   seed=0) for name, k in (("CNNRNN", N_TONES), ("CNN", N_SYLLS))]
        trainer = SynthesisTrainer(SynthesisModelCNN(mel_dim, sz["non"], SYN_LENGTH),
                                   *classifiers, world["config"]["tone_dynamic_mapping"],
                                   learning_rate=SYN_LR, schedule_decay=SYN_DECAY, seed=4,
                                   verbose=False, device=device)
        trainer.init()
        train_step_times(card, {f"SynthesisFull b{n}": (trainer, tuple(t.to(device) for t in batch(n)))
                                for n in (SYN_BATCH, 32)})
        del trainer
    model = init_params(SynthesisModelCNN(mel_dim, sz["non"], SYN_LENGTH, dropout=0.0), seed=4)
    held_step_parity(card, "SynthesisFull", model, batch(SYN_BATCH), device, l1,
                     learning_rate=SYN_LR, weight_decay=SYN_DECAY, decay_all=True)


def synthesis_phase(card: str, device: str = "cuda", sizes: dict = SYN_FULL) -> None:
    """The data path, then synthesizer training at the paper's SynthesisFull
    widths through ``train_synthesizer.run`` with its checks, serving of
    its checkpoints, card vs CPU step parity and the step timings (card
    only). ``device="cpu", sizes=SYN_REHEARSAL`` rehearses it on a CPU."""
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir

    cuda_iir.LAUNCHES = 0
    data_path_phase(device)
    with tempfile.TemporaryDirectory() as root:
        world = write_synthesis_world(root, sizes)
        stage = synthesis_stage(card, device, root, world, sizes)
        synthesis_serving(card, device, world, stage, sizes)
    synthesis_steps(card, device, world, sizes)
    print(f"K1 launches during the synthesizer phase: {cuda_iir.LAUNCHES}")
    check(cuda_iir.LAUNCHES == 0, "K1 launched during the synthesizer phase")


def write_artifacts(root: str, rng) -> dict:
    """Seeded random-weight checkpoints, channel/config JSON, an epoch npz
    and a continuous recording at the bench shapes."""
    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import (
        build_synthesis_model,
        get_classifier_by_name,
    )
    from decode_tonal_langauge_tpu_torch.serving import save_checkpoint

    n_ch, n_disc, length, n_tones, n_sylls = 32, 6, 200, 4, 8
    mel_kwargs = {"n_mels": 128, "n_fft": 2048, "hop_length": 512}
    channels = {
        "active_channels": list(range(n_ch)),
        "tone_discriminative": list(range(n_disc)),
        "syllable_discriminative": list(range(n_disc, 2 * n_disc)),
    }
    config = {
        "n_tones": n_tones,
        "n_syllables": n_sylls,
        "tone_dynamic_mapping": {
            str(k): list(np.linspace(0, 1, 10)) for k in range(n_tones)
        },
        "mel_kwargs": mel_kwargs,
    }
    paths = {k: os.path.join(root, f"{k}.json") for k in ("channels", "config")}
    for key, obj in (("channels", channels), ("config", config)):
        with open(paths[key], "w") as f:
            json.dump(obj, f)

    def scaler():
        return (rng.standard_normal((1, n_disc, length)).astype(np.float32) * 0.1,
                rng.random((1, n_disc, length)).astype(np.float32) + 0.5)

    models = {
        "tone": (init_params(get_classifier_by_name(
            "CNNRNN", n_tones, n_disc, length), seed=0), scaler()),
        "syll": (init_params(get_classifier_by_name(
            "CNN", n_sylls, n_disc, length), seed=1), scaler()),
        "synth": (init_params(build_synthesis_model(
            "SynthesisLite", 128 * 20, n_ch - 2 * n_disc, length), seed=2), None),
    }
    for key, (model, sc) in models.items():
        paths[key] = save_checkpoint(os.path.join(root, f"{key}.pt"), model, sc)

    n_trials = 32
    ecog = rng.standard_normal((n_trials, n_ch, length)).astype(np.float32)
    paths["samples"] = os.path.join(root, "samples.npz")
    np.savez(paths["samples"], ecog=ecog,
             tone=rng.integers(0, n_tones, n_trials),
             syllable=rng.integers(0, n_sylls, n_trials))
    paths["recording"] = os.path.join(root, "recording.npz")
    np.savez(paths["recording"],
             ecog=rng.standard_normal((n_ch, 60 * 400)).astype(np.float32),
             ecog_sf=400.0)
    return {"paths": paths, "channels": channels, "config": config,
            "ecog": ecog, "length": length}


def cli_args(paths: dict, out_dir: str, device: str, stream: bool) -> list:
    args = [
        "--channel_file", paths["channels"], "--config_file", paths["config"],
        "--tone_model_name", "CNNRNN", "--tone_model_path", paths["tone"],
        "--syllable_model_name", "CNN", "--syllable_model_path", paths["syll"],
        "--synthesis_model_name", "SynthesisLite",
        "--synthesis_model_path", paths["synth"],
        "--output_dir", out_dir, "--n_wavs", "4", "--device", device,
    ]
    if stream:
        return args + ["--stream_recording", paths["recording"],
                       "--stream_window_s", "0.5", "--stream_hop_s", "0.1"]
    return args + ["--sample_path", paths["samples"]]


def serving_phase(card: str, device: str = "cuda") -> None:
    import torch

    from decode_tonal_langauge_tpu_torch import serving

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as root:
        art = write_artifacts(root, rng)
        paths, channels, config = art["paths"], art["channels"], art["config"]

        # The serving CLI, epoch mode then stream mode.
        epoch_dir = os.path.join(root, "epoch")
        summary = serving.run(serving.build_parser().parse_args(
            cli_args(paths, epoch_dir, device, stream=False)))
        check(summary["n_trials"] == 32 and summary["n_wavs"] == 4,
              f"epoch CLI summary {summary}")
        for name in ("predictions.csv", "mels.npz", "summary.json",
                     "decoded_0.wav", "decoded_3.wav"):
            check(os.path.exists(os.path.join(epoch_dir, name)),
                  f"epoch CLI wrote no {name}")
        stream_dir = os.path.join(root, "stream")
        summary = serving.run(serving.build_parser().parse_args(
            cli_args(paths, stream_dir, device, stream=True)))
        check(summary["n_windows"] == 596, f"stream CLI summary {summary}")
        for name in ("windows.csv", "events.csv", "mels.npz", "summary.json",
                     "decoded_w0.wav"):
            check(os.path.exists(os.path.join(stream_dir, name)),
                  f"stream CLI wrote no {name}")

        def decoder(dev):
            return serving.load_decoder(
                channels, config, art["length"], "CNNRNN", paths["tone"],
                "CNN", paths["syll"], synthesis_model_name="SynthesisLite",
                synthesis_model_path=paths["synth"], device=dev)

        ecog = art["ecog"]
        dec = decoder(device)
        out = dec.decode(ecog, channels)
        ref = decoder("cpu").decode(ecog, channels)
        check(out["mel"].shape == (32, 128 * 20) and np.isfinite(out["mel"]).all(),
              f"mel shape {out['mel'].shape} / non-finite")
        for key in ("tone", "syllable"):
            probs = ref[f"{key}_probs"]
            top2 = np.sort(probs, axis=1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 1e-4
            check((out[key][clear] == ref[key][clear]).all(),
                  f"{key} ids differ between {device} and cpu")
            err = np.abs(out[f"{key}_probs"] - probs).max()
            check(err <= 1e-4, f"{key} probs differ by {err}")
            print(f"{key}: ids equal on {clear.sum()}/32 trials with a clear "
                  f"top-2 margin, probs max abs diff {err:.3g} ({device} vs cpu)")
        check(np.allclose(out["mel"], ref["mel"], rtol=1e-3, atol=1e-3),
              f"mels differ: {np.abs(out['mel'] - ref['mel']).max()}")
        print(f"mel: max abs diff {np.abs(out['mel'] - ref['mel']).max():.3g} "
              f"({device} vs cpu)")

        waves = dec.synthesize_wavs(out["mel"], 24414, config["mel_kwargs"])
        check(len(waves) == 32 and all(
            w.shape == (512 * 19,) and np.isfinite(w).all() for w in waves),
            "waveforms: wrong shape or non-finite")

        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

        def wall(fn, runs=5):
            fn()
            times = []
            for _ in range(runs):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                times.append(time.perf_counter() - t0)
            return float(np.median(times))

        recording = np.load(paths["recording"])["ecog"]
        t_decode = wall(lambda: dec.decode(ecog, channels))
        t_stream = wall(lambda: dec.decode_stream(recording, channels, 200, 40),
                        runs=3)
        t_waves = wall(lambda: dec.synthesize_wavs(
            out["mel"], 24414, config["mel_kwargs"]), runs=3)
        print(f"epoch decode: {32 / t_decode:.1f} trials/s (batch 32, "
              f"{t_decode * 1e3:.2f} ms) [{card}]")
        print(f"stream decode: {596 / t_stream:.1f} windows/s (596 windows, "
              f"{t_stream * 1e3:.1f} ms, real-time factor {60 / t_stream:.1f}) "
              f"[{card}]")
        print(f"Griffin-Lim: {32 / t_waves:.1f} waves/s (batch 32, "
              f"{t_waves * 1e3:.1f} ms) [{card}]")


# The pipeline phase: configs/example_config.yaml through pipeline.run_pipeline
# on a synthetic subject of 128 channels, raw at 1000 Hz, 2 blocks x 160
# trials (4 tones x 2 syllables, 40 trials a class), 0.5 s epochs, the
# paper's CNN syllable / CNN-RNN tone pairing at full width. A rehearsal
# size runs the same code on a CPU.
PIPE_FULL = dict(channels=128, trials_per_block=160, lstm_dim=800)
PIPE_REHEARSAL = dict(channels=16, trials_per_block=16, lstm_dim=200)
PIPE_SF, PIPE_EPOCH_S, PIPE_BATCH = 1000.0, 0.5, 32
# p against the CPU (tests/test_torch_channel_selection.py): rtol 1e-4 where
# p < 1e-3 (down to 1e-30, below which both only stay below it), atol 1e-3
# elsewhere (float32 forms x = dfd/(dfd + dfn*F), which moves p near 1).
P_RTOL, P_ATOL, P_SMALL, P_FLOOR = 1e-4, 1e-3, 1e-3, 1e-30


def shipped_config(name: str, root: str) -> dict:
    """``configs/<name>`` with its paths under ``root``, 0.5 s epochs and
    no confusion figure (no matplotlib on the card's machine)."""
    from decode_tonal_langauge_tpu_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configs", name))
    pre = cfg["preprocess"]["params"]
    pre["io"]["params"].update(root_dir=f"{root}/raw", output_dir=f"{root}/processed")
    collect = cfg["sample_collection"]["params"]
    collect["io"].update(output_dir=f"{root}/samples", textgrid_root=f"{root}/raw")
    collect["subjects"][1]["sample_length"] = PIPE_EPOCH_S
    cfg["channel_selection"]["params"]["io"]["output_dir"] = f"{root}/selection"
    cfg["training"]["params"]["io"]["log_dir"] = f"{root}/logs"
    cfg["evaluation"]["metrics"] = ["accuracy", "f1_score"]
    return cfg


def pipeline_config(root: str, sz: dict) -> dict:
    """``configs/example_config.yaml`` (``shipped_config``) with the
    phase's sizes: the paper's pairing through ``model.per_target``, 2
    seeds x 3 epochs at batch 32, checkpoints, and the evaluation stage
    on."""
    cfg = shipped_config("example_config.yaml", root)
    cfg["model"] = {
        "model": "models.deep_classifiers.CNNClassifier", "model_name": "CNN",
        "model_kwargs": {},
        "per_target": {"tone": {"model": "models.deep_classifiers.CNNRNNClassifier",
                                "model_kwargs": {"lstm_dim": sz["lstm_dim"]}}},
    }
    train = cfg["training"]["params"]
    train["experiment"]["repeat"] = 2
    train["training"].update(batch_size=PIPE_BATCH, epochs=3, patience=60,
                             save_checkpoints=True)
    cfg["evaluation"]["module"] = "evaluation_main"
    return cfg


def p_close(got: np.ndarray, want: np.ndarray) -> bool:
    small = (want < P_SMALL) & (want >= P_FLOOR)
    return bool(np.allclose(got[small], want[small], rtol=P_RTOL, atol=0)
                and np.allclose(got[~(want < P_SMALL)], want[~(want < P_SMALL)],
                                rtol=0, atol=P_ATOL)
                and (got[want < P_FLOOR] < P_FLOOR).all())


def anova_times(card: str, sample_path: str, device: str) -> None:
    """Wall, device time and launches of the stage's two ANOVAs on the
    phase's data (torch.profiler), on the card only."""
    import torch

    from decode_tonal_langauge_tpu_torch._timing import device_events
    from decode_tonal_langauge_tpu_torch.ops import anova

    data = np.load(sample_path)
    rest = torch.as_tensor(data["ecog_rest"], device=device)
    erp = torch.as_tensor(data["ecog"], device=device)
    _, tone = np.unique(data["tone"], return_inverse=True)
    calls = {
        "active (two groups)": lambda: anova.f_oneway_two_groups(rest, erp),
        "tone (4 groups)": lambda: anova.f_oneway_labeled(erp, tone, 4),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rows = device_events(fn, runs=5)
        check(rows, f"torch.profiler saw no device time for the {name} ANOVA")
        busy = sum(r[0] for r in rows)
        launches = sum(r[1] for r in rows)
        wall_ms = 1e3 * float(np.median(walls))
        print(f"ANOVA {name}, {erp.shape[1]} x {erp.shape[2]} x ({erp.shape[0]} + "
              f"{rest.shape[0]} rest) trials: {wall_ms:.2f} ms wall (median of 5), "
              f"{busy:.3f} ms device ({100 * busy / wall_ms:.1f}% busy), "
              f"{launches:.0f} device operations [{card}]")
        for ms, n, op in rows[:4]:
            print(f"    {ms:8.4f} ms  x{n:<6g} {op[:100]}")


def pipeline_serving(card: str, device: str, outputs: dict, fits: dict, seeds) -> None:
    """``serving --training_dir`` on the subject's npz, then on the first
    seed's test trials in the trainer's padded batches (its own padding):
    those ids must equal the trainer's test predictions."""
    from decode_tonal_langauge_tpu_torch import serving
    from decode_tonal_langauge_tpu_torch.data.splits import split_indices

    sample = os.path.join(outputs["sample_collection"], "subject_1.npz")
    data = np.load(sample)
    n = data["ecog"].shape[0]
    dev = [] if device == "cuda" else ["--device", device]
    out_dir = os.path.join(os.path.dirname(outputs["training"]), "served")
    t0 = time.perf_counter()
    summary = serving.run(serving.build_parser().parse_args(
        ["--training_dir", outputs["training"], "--sample_path", sample,
         "--output_dir", out_dir, "--n_wavs", "0", "--device", device]))
    wall = time.perf_counter() - t0
    check(summary["n_trials"] == n and os.path.exists(os.path.join(out_dir, "predictions.csv")),
          f"serving --training_dir summary {summary}")
    ids = {k: np.array([int(r[f"{k}_pred"]) for r in read_csv(
        os.path.join(out_dir, "predictions.csv"))]) for k in ("tone", "syllable")}

    seed = int(seeds[0])
    _, _, te = split_indices(n, [0.7, 0.1, 0.2], seed=seed)
    pad = -len(te) % PIPE_BATCH
    x = np.concatenate([data["ecog"][te], np.repeat(data["ecog"][te[:1]], pad, axis=0)])
    batched = {"tone": [], "syllable": []}
    for i, lo in enumerate(range(0, len(x), PIPE_BATCH)):
        path = os.path.join(os.path.dirname(out_dir), f"test_batch_{i}.npz")
        np.savez(path, ecog=x[lo:lo + PIPE_BATCH], ecog_sf=data["ecog_sf"])
        chunk = os.path.join(os.path.dirname(out_dir), f"served_batch_{i}")
        serving.run(serving.build_parser().parse_args(
            ["--training_dir", outputs["training"], "--sample_path", path,
             "--subject_id", "1", "--seed", str(seed), "--output_dir", chunk,
             "--n_wavs", "0"] + dev))
        for row in read_csv(os.path.join(chunk, "predictions.csv")):
            for k in batched:
                batched[k].append(int(row[f"{k}_pred"]))
    for k in ("tone", "syllable"):
        got = np.array(batched[k][:len(te)])
        want = fits[k][seed]
        check(np.array_equal(got, want),
              f"serving --training_dir: {k} ids differ from the trainer's test "
              f"predictions on {int((got != want).sum())} of {len(te)} trials")
        whole = int((ids[k][te] != want).sum())
        print(f"serving --training_dir: {k} ids equal to the trainer's on the {len(te)} "
              f"test trials of seed {seed} (in batches of {PIPE_BATCH}); the one-pass "
              f"decode of all {n} trials differs from them on {whole}")
    print(f"serving --training_dir, {n} trials in one pass: {wall:.2f} s wall (models "
          f"loaded from the run's provenance), tone accuracy "
          f"{summary['tone_accuracy']:.3f}, syllable {summary['syllable_accuracy']:.3f} "
          f"[{card}]")


def run_recorded_pipeline(config: dict, device: str):
    """``pipeline.run_pipeline`` on ``device`` (the card by default),
    recording each target's test predictions by seed from the trainer.
    Returns (outputs, fits, wall s, peak MiB, K1 launches)."""
    import torch

    from decode_tonal_langauge_tpu_torch import pipeline
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.training import classifier_pipeline

    on_card = device == "cuda"
    fits, fit_all = {}, classifier_pipeline._fit_eval_all_seeds

    def recording(*args, target_str=None, **kwargs):
        results = fit_all(*args, target_str=target_str, **kwargs)
        fits[target_str] = {r.seed: r.test_preds for r in results}
        return results

    classifier_pipeline._fit_eval_all_seeds = recording
    launches = cuda_iir.LAUNCHES
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        outputs = pipeline.run_pipeline(config, device=None if on_card else device)
        wall = time.perf_counter() - t0
    finally:
        classifier_pipeline._fit_eval_all_seeds = fit_all
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else float("nan")
    return outputs, fits, wall, peak, cuda_iir.LAUNCHES - launches


def pipeline_phase(card: str, device: str = "cuda", sizes: dict = PIPE_FULL) -> None:
    """The YAML pipeline through ``pipeline.run_pipeline`` on the card:
    preprocess, sample collection, channel selection, training,
    evaluation and visualisation of one synthetic subject; then the
    channel selection repeated on the CPU, evaluation held to training,
    ``serving --training_dir``, the ANOVA's times, and K1's launches."""
    from decode_tonal_langauge_tpu_torch.channel_selection import active, discriminative
    from decode_tonal_langauge_tpu_torch.channel_selection import main as cs_main
    from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject
    from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream

    on_card = device == "cuda"
    spec = SyntheticSpec(n_channels=sizes["channels"], ecog_sf=PIPE_SF, n_blocks=2,
                         trials_per_block=sizes["trials_per_block"])
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_subject(f"{root}/raw", 1, spec)
        print(f"pipeline phase: synthetic subject of {spec.n_channels} channels at "
              f"{PIPE_SF:.0f} Hz, 2 x {spec.trials_per_block} trials written in "
              f"{time.perf_counter() - t0:.1f} s")
        config = pipeline_config(root, sizes)
        outputs, fits, wall, peak, k1 = run_recorded_pipeline(config, device)
        print(f"pipeline: {wall:.2f} s wall for all stages, peak {peak:.0f} MiB "
              f"allocated, K1 launches {k1} [{card}]")
        check(k1 == 0, "K1 launched during the pipeline phase")

        # Each stage's output exists and was threaded downstream.
        stages = ["preprocess", "sample_collection", "channel_selection", "training",
                  "evaluation"]
        check(all(s in outputs and os.path.isdir(outputs[s]) for s in stages),
              f"stage outputs {outputs}")
        io = {s: config[s]["params"]["io"] for s in stages[1:]}
        threaded = [
            io["sample_collection"]["recording_dir"] == outputs["preprocess"],
            io["channel_selection"]["sample_dir"] == outputs["sample_collection"],
            io["training"]["sample_dir"] == outputs["sample_collection"],
            io["training"]["channel_selection_dir"] == outputs["channel_selection"],
            io["evaluation"]["training_dir"] == outputs["training"],
            config["visualisation"]["params"]["io"]["results_dir"] == outputs["training"],
        ]
        check(all(threaded), f"stage outputs not threaded downstream: {threaded}")
        if on_card:
            check("visualisation" not in outputs,
                  "the visualisation stage made figures on a machine without matplotlib")

        sample = os.path.join(outputs["sample_collection"], "subject_1.npz")
        data = np.load(sample)
        n = 2 * spec.trials_per_block
        length = int(PIPE_EPOCH_S * 400)
        check(data["ecog"].shape == (n, spec.n_channels, length)
              and data["ecog_rest"].shape[1:] == (spec.n_channels, length)
              and np.isfinite(data["ecog"]).all(),
              f"sample npz ecog {data['ecog'].shape}, rest {data['ecog_rest'].shape}")
        with open(os.path.join(outputs["channel_selection"], "subject_1.json")) as f:
            selection = json.load(f)
        planted = {"active_channels": set(spec.active_channels),
                   "tone_discriminative": set(spec.tone_channels),
                   "syllable_discriminative": set(spec.syllable_channels)}
        for key, chans in planted.items():
            check(set(selection[key]) & chans, f"{key} {selection[key]} holds none of "
                  f"the planted channels {sorted(chans)}")
        print("channel selection: " + ", ".join(
            f"{k} {len(v)} ({len(set(v) & planted[k])} of {len(planted[k])} planted)"
            for k, v in selection.items()))

        # The stage again on the device (warm) and on the CPU: equal JSONs.
        walls = {}
        for where in (device, "cpu"):
            again = {"channel_selection": json.loads(json.dumps(config["channel_selection"]))}
            again["channel_selection"]["params"]["io"]["output_dir"] = f"{root}/selection_{where}"
            t0 = time.perf_counter()
            out_dir = cs_main.run(again, device=where)
            walls[where] = time.perf_counter() - t0
            with open(os.path.join(out_dir, "subject_1.json")) as f:
                check(json.load(f) == selection,
                      f"channel selection: the {where} rerun's JSON differs from the pipeline's")
        print(f"channel-selection stage rerun (npz load, three ANOVAs, JSON): "
              f"{walls[device]:.3f} s on {device} (warm), {walls['cpu']:.3f} s on the CPU "
              f"[{card}]")
        for sel in config["channel_selection"]["params"]["selections"]:
            plugin = active if sel["module"].endswith("active") else discriminative
            got = plugin.run(data, sel["params"], device=device)["p_values"]
            want = plugin.run(data, sel["params"], device="cpu")["p_values"]
            check(p_close(got, want), f"{sel['selection_name']}: card p vs CPU p beyond "
                  f"rtol {P_RTOL} (p < {P_SMALL}) / atol {P_ATOL}")
        print("channel selection: card JSON equal to the CPU's; p within rtol 1e-4 "
              "(p < 1e-3) / atol 1e-3 of the CPU's for all three selections")

        # Evaluation rows equal training rows; serving from --training_dir.
        train_rows = read_csv(os.path.join(outputs["training"], "results.csv"))
        eval_rows = read_csv(os.path.join(outputs["evaluation"], "results.csv"))
        check([r["target"] for r in train_rows] == ["syllable, tone", "syllable", "tone"],
              f"results.csv targets {[r['target'] for r in train_rows]}")
        check(eval_rows == train_rows, "evaluation rows differ from the training rows")
        print("evaluation: rows equal to training's; accuracy_all " + ", ".join(
            f"{r['target']} {r['accuracy_all']}" for r in eval_rows))
        seeds = [int(s) for s in seed_stream(42, 2)]
        pipeline_serving(card, device, outputs, fits, seeds)
        if on_card:
            anova_times(card, sample, device)


# The bf16 phase: the compute dtype of configs/fast_bf16.yaml (model_kwargs:
# {dtype: bfloat16}), train_synthesizer --dtype and serving --synthesis_dtype on
# the card. Tolerances are tests/test_torch_bf16.py's: class probabilities (an f32
# head over bf16 features) within 2e-3, mels within rtol 2^-6 and an atol of 2^-6
# of their largest magnitude (four bf16 roundings).
BF16_PROB_ATOL = 2e-3
BF16_EPOCHS, BF16_SEEDS = 3, 4


def bf16_close(got: np.ndarray, want: np.ndarray) -> bool:
    scale = float(np.abs(want).max())
    return bool(np.allclose(got, want, rtol=2**-6, atol=2**-6 * scale))


def bf16_classifier(name: str, dtype: str, seed: int, sizes=None):
    """The full-width CNN (8 syllables) or CNN-RNN (4 tones, lstm_dim 800)
    on TRAIN_CHANNELS x TRAIN_LENGTH in ``dtype``, with seeded weights (the
    same for every dtype: the parameters are float32 either way)."""
    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name

    n_classes, kwargs = {"CNN": (N_SYLLS, {}), "CNNRNN": (N_TONES, {"lstm_dim": 800})}[name]
    return init_params(get_classifier_by_name(
        name, n_classes, TRAIN_CHANNELS, TRAIN_LENGTH, {**kwargs, "dtype": dtype}), seed=seed)


def bf16_step_times(card: str, device: str, sz: dict) -> None:
    """One train step of the full-width CNN and CNN-RNN at batch 32 and of
    SynthesisFull at batch 8 and 32, in float32 and in bf16 from the same
    seeded weights, and in bf16 once more with cuBLAS allowed to reduce
    half-precision GEMMs in bf16 (``exact_f32`` without its
    ``f32_accumulation``): wall, device work, operations, top device ops
    and peak memory of each (``step_profile``)."""
    from unittest import mock

    import torch

    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN
    from decode_tonal_langauge_tpu_torch.runtime import device as device_mod
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import SynthesisTrainer
    from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, TRAIN_CHANNELS, TRAIN_LENGTH)).astype(np.float32)).to(device)
    cases = []
    for name in ("CNN", "CNNRNN"):
        n_classes = N_SYLLS if name == "CNN" else N_TONES
        y = torch.from_numpy(rng.integers(0, n_classes, TRAIN_BATCH)).to(device)

        def classifier(dtype, name=name, n_classes=n_classes):
            trainer = ClassifierTrainer(bf16_classifier(name, dtype, 3), n_classes,
                                        learning_rate=TRAIN_LR, weight_decay=0.01,
                                        batch_size=TRAIN_BATCH, seed=3, device=device)
            trainer.init()
            return trainer
        cases.append((name, TRAIN_BATCH, classifier,
                      (x, y, torch.ones(TRAIN_BATCH, device=device))))
    mel_dim = sz["n_mels"] * 20
    frozen = [bf16_classifier(n, "float32", 0) for n in ("CNNRNN", "CNN")]
    for n in (SYN_BATCH, 32):
        def synthesizer(dtype):
            trainer = SynthesisTrainer(
                SynthesisModelCNN(mel_dim, sz["non"], SYN_LENGTH, dtype=dtype), *frozen,
                {str(k): [0.5] * sz["n_dyn"] for k in range(N_TONES)},
                learning_rate=SYN_LR, schedule_decay=SYN_DECAY, seed=4, verbose=False,
                device=device)
            trainer.init()
            return trainer
        cases.append(("SynthesisFull", n, synthesizer,
                      tuple(t.to(device) for t in synthesis_batch(rng, n, sz))))

    table = []
    for name, n, make, batch in cases:
        walls = {}
        for variant in ("float32", "bfloat16", "bfloat16, bf16 reductions"):
            if variant != "bfloat16, bf16 reductions":  # that one times the bf16 trainer on
                trainer = make(variant)
                torch.cuda.empty_cache()
            step = lambda: trainer.train_step(*batch)  # noqa: E731
            if variant.endswith("reductions"):
                with mock.patch.object(device_mod, "f32_accumulation", contextlib.nullcontext):
                    prof = step_profile(step)
            else:
                prof = step_profile(step)
            check(prof["rows"], f"torch.profiler saw no device time in a {name} {variant} step")
            print_step(card, f"{name} {variant}", n, prof, top=10)
            walls[variant] = prof["wall_ms"]
            table.append({"model": name, "batch": n, "dtype": variant,
                          **{k: round(v, 3) for k, v in prof.items() if k != "rows"}})
        del trainer
        print(f"{name} batch {n}: bf16 step {walls['bfloat16']:.2f} ms against float32 "
              f"{walls['float32']:.2f} ms ({walls['float32'] / walls['bfloat16']:.2f}x); "
              f"with bf16 reductions allowed {walls['bfloat16, bf16 reductions']:.2f} ms "
              f"[{card}]")
    print("bf16 step table: " + json.dumps(table))


def bf16_card_vs_cpu(card: str, device: str, sz: dict) -> None:
    """A bf16 forward of the full-width CNN and CNN-RNN (batch 32) and of
    SynthesisFull (batch 8) on the card and on the CPU from the same
    weights: probabilities within BF16_PROB_ATOL, ids equal where the
    CPU's top-2 margin exceeds it, outputs not all on the bf16 grid (the
    head computes in f32), mels within ``bf16_close``. Then two gradients
    of the bf16 SynthesisFull under the synthesizer step's deterministic
    cuDNN must be equal bit for bit."""
    import copy

    import torch

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN
    from decode_tonal_langauge_tpu_torch.runtime.device import exact_f32

    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, TRAIN_CHANNELS, TRAIN_LENGTH)).astype(np.float32))

    def both(model, *inputs):
        outs = []
        for dev in (device, "cpu"):
            m = copy.deepcopy(model).to(dev).eval()
            with torch.no_grad(), exact_f32():
                out = m(*(t.to(dev) for t in inputs))
            check(out.dtype == torch.float32, f"{type(model).__name__} output {out.dtype}")
            outs.append(out.cpu())
        return outs

    for name in ("CNN", "CNNRNN"):
        card_p, cpu_p = both(bf16_classifier(name, "bfloat16", 5), x)
        diff = float((card_p - cpu_p).abs().max())
        top2 = cpu_p.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > BF16_PROB_ATOL
        same = bool((card_p.argmax(1) == cpu_p.argmax(1))[clear].all())
        on_grid = bool(torch.equal(card_p, card_p.bfloat16().float()))
        check(diff <= BF16_PROB_ATOL and same and not on_grid,
              f"{name} bf16 card vs cpu: probabilities {diff:.3g} apart (limit "
              f"{BF16_PROB_ATOL}), ids equal where clear {same}, all on the bf16 grid {on_grid}")
        print(f"{name} bf16 forward, batch {TRAIN_BATCH}: card vs CPU probabilities max abs "
              f"diff {diff:.3g}, ids equal on the {int(clear.sum())} trials with a top-2 "
              f"margin over {BF16_PROB_ATOL}, outputs off the bf16 grid (f32 head) [{card}]")

    mel_dim = sz["n_mels"] * 20
    synth = init_params(SynthesisModelCNN(mel_dim, sz["non"], SYN_LENGTH, dropout=0.0,
                                          dtype="bfloat16"), seed=6)
    batch = synthesis_batch(rng, SYN_BATCH, sz)
    card_m, cpu_m = both(synth, *batch[:2])
    diff = float((card_m - cpu_m).abs().max())
    check(bf16_close(card_m.numpy(), cpu_m.numpy()),
          f"SynthesisFull bf16 card vs cpu: mels {diff:.3g} apart")
    print(f"SynthesisFull bf16 forward, batch {SYN_BATCH}: card vs CPU mels max abs diff "
          f"{diff:.3g} (largest |mel| {float(cpu_m.abs().max()):.3g}) [{card}]")

    model = synth.to(device).train()
    inputs = tuple(t.to(device) for t in batch)
    grads = []
    for _ in range(2):
        with exact_f32(deterministic=True):
            out = model(*inputs[:2])
            loss = ((out - inputs[2]).abs().mean(dim=1) * inputs[3]).sum()
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
    equal = all(torch.equal(a, b) for a, b in zip(*grads))
    check(equal, "SynthesisFull bf16: two gradients under deterministic cuDNN differ")
    print("SynthesisFull bf16 under deterministic cuDNN (the synthesizer step's): two "
          "gradients of one batch equal bit for bit")


def bf16_pipeline_config(root: str, sz: dict) -> dict:
    """``configs/fast_bf16.yaml`` rewritten as the example is
    (``shipped_config``); its model pairing (CNN syllable, CNN-RNN tone,
    both bf16), ``repeat: 4``, batch 32, bf16 moments, checkpoints and
    evaluation kept; epochs cut from 60 to BF16_EPOCHS; lstm_dim written
    out (800, the default)."""
    cfg = shipped_config("fast_bf16.yaml", root)
    cfg["model"]["per_target"]["tone"]["model_kwargs"]["lstm_dim"] = sz["lstm_dim"]
    cfg["training"]["params"]["training"]["epochs"] = BF16_EPOCHS
    return cfg


def bf16_pipeline(card: str, device: str, sz: dict) -> None:
    """``configs/fast_bf16.yaml`` through ``pipeline.run_pipeline`` on the
    pipeline phase's synthetic subject: every stage, evaluation rows equal
    to training's for all BF16_SEEDS seeds, the bf16 models named in the
    rows and in the provenance, ``serving --training_dir`` ids equal to
    the trainer's test predictions."""
    from decode_tonal_langauge_tpu_torch.config import load_config
    from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject
    from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream

    spec = SyntheticSpec(n_channels=sz["channels"], ecog_sf=PIPE_SF, n_blocks=2,
                         trials_per_block=sz["trials_per_block"])
    with tempfile.TemporaryDirectory() as root:
        write_subject(f"{root}/raw", 1, spec)
        config = bf16_pipeline_config(root, sz)
        outputs, fits, wall, peak, k1 = run_recorded_pipeline(config, device)
        print(f"fast_bf16 pipeline: {wall:.2f} s wall for all stages, peak {peak:.0f} MiB "
              f"allocated, K1 launches {k1} [{card}]")
        check(k1 == 0, "K1 launched during the fast_bf16 pipeline")
        train_rows = read_csv(os.path.join(outputs["training"], "results.csv"))
        eval_rows = read_csv(os.path.join(outputs["evaluation"], "results.csv"))
        check({r["target"]: r["model_name"] for r in train_rows}
              == {"syllable, tone": "cnn_bf16", "syllable": "cnn_bf16", "tone": "cnnrnn_bf16"},
              f"results.csv targets and models {[(r['target'], r['model_name']) for r in train_rows]}")
        check(all(len(json.loads(r["accuracy_all"])) == BF16_SEEDS for r in train_rows),
              f"accuracy_all {[r['accuracy_all'] for r in train_rows]}")
        check(eval_rows == train_rows, "fast_bf16: evaluation rows differ from the training rows")
        provenance = load_config(os.path.join(outputs["training"], "config.yaml"))
        check(provenance["model"]["model_kwargs"] == {"dtype": "bfloat16"}
              and provenance["model"]["per_target"]["tone"]["model_kwargs"]["dtype"] == "bfloat16",
              f"provenance model section {provenance['model']}")
        print("fast_bf16 evaluation: rows equal to training's for all "
              f"{BF16_SEEDS} seeds; accuracy_all " + ", ".join(
                  f"{r['target']} {r['accuracy_all']}" for r in eval_rows))
        pipeline_serving(card, device, outputs, fits,
                         [int(s) for s in seed_stream(42, BF16_SEEDS)])


def bf16_synthesizer(card: str, device: str, sz: dict) -> None:
    """``train_synthesizer --dtype bfloat16 --moment_dtype bfloat16`` on
    the synthesizer phase's world, 1 seed x 3 epochs: test MCD below the
    zero predictor's; then ``serving --synthesis_dtype bfloat16`` on its
    checkpoint, whose test mels, decoded in the trainer's batches, lie
    within ``bf16_close`` of ``evaluate``'s."""
    import torch

    from decode_tonal_langauge_tpu_torch import serving
    from decode_tonal_langauge_tpu_torch.data.splits import split_indices
    from decode_tonal_langauge_tpu_torch.training import synthesis_trainer
    from decode_tonal_langauge_tpu_torch.training import train_synthesizer as stage
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import compute_mcd

    with tempfile.TemporaryDirectory() as root:
        world = write_synthesis_world(root, sz)
        paths, out = world["paths"], os.path.join(root, "bf16")
        args = synthesizer_args(paths, out, device, "--dtype", "bfloat16",
                                "--moment_dtype", "bfloat16")
        args[args.index("--repeat") + 1] = "1"
        fits, fit_eval = [], synthesis_trainer.fit_eval_seed

        def recording(trainer, *a, **kw):
            fits.append((trainer, fit_eval(trainer, *a, **kw)))
            return fits[-1][1]

        synthesis_trainer.fit_eval_seed = recording  # one seed: the seed loop
        try:
            t0 = time.perf_counter()
            summary = stage.run(stage.build_parser().parse_args(args))
            stage_s = time.perf_counter() - t0
        finally:
            synthesis_trainer.fit_eval_seed = fit_eval
        (trainer, (history, mcd, recon, origin)), = fits
        check(trainer.model.dtype == torch.bfloat16
              and all(p.dtype == torch.float32 for p in trainer.model.parameters())
              and all(m.dtype == torch.bfloat16 for m in trainer.optimizer.mu),
              "the bf16 synthesizer's model, parameters or moments have other dtypes")
        seed = trainer.seed
        te = split_indices(sz["trials"], [0.9, 0.1], seed=seed)[-1]
        zero = compute_mcd(origin, np.zeros_like(origin))
        check(np.isfinite(history).all() and np.isfinite(recon).all() and mcd < zero,
              f"bf16 synthesizer: history {history}, test MCD {mcd} (zero predictor {zero})")
        print(f"bf16 synthesizer stage, SynthesisFull ({summary['model_size']:,} parameters), "
              f"1 seed x {SYN_EPOCHS} epochs at batch {SYN_BATCH}, bf16 moments: "
              f"{stage_s:.2f} s wall, test MCD {mcd:.2f} (zero predictor ~{zero:.0f}), mel r "
              f"{summary['mel_pearson_r_mean']:.4f} [{card}]")

        ckpt = os.path.join(out, "ckpts", f"SynthesisFull_seed_{seed}")
        served_summary = serving.run(serving.build_parser().parse_args([
            "--sample_path", paths["sample"], "--channel_file", paths["channels"],
            "--config_file", paths["config"], "--tone_model_name", "CNNRNN",
            "--tone_model_path", paths["tone"], "--syllable_model_name", "CNN",
            "--syllable_model_path", paths["syll"], "--synthesis_model_name", "SynthesisFull",
            "--synthesis_model_path", ckpt, "--synthesis_dtype", "bfloat16",
            "--audio_sampling_rate", str(SYN_SR), "--output_dir", os.path.join(out, "served"),
            "--n_wavs", "1", "--device", device]))
        check(np.isfinite(served_summary["mel_mcd"]), f"serving summary {served_summary}")
        decoder = serving.load_decoder(
            world["channels"], world["config"], SYN_LENGTH, "CNNRNN", paths["tone"], "CNN",
            paths["syll"], synthesis_model_name="SynthesisFull", synthesis_model_path=ckpt,
            synthesis_dtype="bfloat16", device=device)
        ecog = world["ecog"][te]
        served = np.concatenate([decoder.decode(ecog[lo:lo + SYN_BATCH], world["channels"])["mel"]
                                 for lo in range(0, len(te), SYN_BATCH)])
        diff = float(np.abs(served - recon).max())
        check(served.dtype == np.float32 and bf16_close(served, recon),
              f"bf16 served mels vs evaluate's: max abs diff {diff}")
        print(f"serving --synthesis_dtype bfloat16: mel_mcd {served_summary['mel_mcd']:.4f} on "
              f"all {sz['trials']} trials; served test mels vs evaluate's max abs diff "
              f"{diff:.3g} (batches of {SYN_BATCH}) [{card}]")


def bf16_phase(card: str, device: str = "cuda", pipe_sizes: dict = PIPE_FULL,
               syn_sizes: dict = SYN_FULL) -> None:
    """bf16 compute on the card: the step times against float32, card vs
    CPU forwards and deterministic cuDNN, ``configs/fast_bf16.yaml``
    through the pipeline, and the bf16 synthesizer trained and served;
    K1 must launch 0 times. ``device="cpu"`` with the rehearsal sizes
    runs it all but the timings on a CPU."""
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir

    cuda_iir.LAUNCHES = 0
    if device == "cuda":
        bf16_step_times(card, device, syn_sizes)
    bf16_card_vs_cpu(card, device, syn_sizes)
    bf16_pipeline(card, device, pipe_sizes)
    bf16_synthesizer(card, device, syn_sizes)
    print(f"K1 launches during the bf16 phase: {cuda_iir.LAUNCHES}")
    check(cuda_iir.LAUNCHES == 0, "K1 launched during the bf16 phase")


# The seed-parallel phase: every repeat seed of an experiment in one batched
# fit (training/seed_parallel.py, training/seed_stack.py) against the seed loop.
# The batched computation is held exactly: two NAdam steps of the stacked seeds
# of each paper model in float64 (dropout on) against each seed's own steps,
# every weight within 1e-9 of its tensor's largest (measured ~1e-13). Rows of
# float32 fits are held by the JAX package's rule for its vmapped fit
# (tests/test_seed_parallel.py:65-85: each history value within rel 2e-3 /
# abs 2e-4 of the loop's, best epoch and stop equal, at most 2 test predictions
# flipped a seed) where the loop reproduces itself under another float32 order
# of its sums: SynthesisFull's 3-epoch fit does (batched within 2.6e-4). The
# paper classifiers' 3-epoch float32 fits at lr 5e-4 do not: the loop under
# deterministic cuDNN left the default loop by up to rel 1.12 (CNN) and 0.125
# (CNN-RNN) with up to 21 of 64 predictions flipped, as far as the batched fit
# did (NAdam's first steps, about lr times the sign of each gradient element,
# turn the last digits of a reordered, nearly cancelling sum into a full step
# either way, and max-pool near-ties route gradients either way). So their
# rows, flips and test accuracies are printed beside that yardstick, and only
# their structure (epochs run, early stop) is held. fast_bf16's bf16 fits with
# seed_parallel on and off likewise: their flips are printed, and each run's
# evaluation rows must equal its training rows.
SP_SEEDS, SP_EPOCHS = 4, 3
SP_ROW_RTOL, SP_ROW_ATOL = 2e-3, 2e-4
SP_F64_ATOL, SP_F64_SEEDS, SP_F64_BATCH = 1e-9, 2, 4
SP_FULL = dict(trials=TRAIN_TRIALS, lstm_dim=800, syn=SYN_FULL, pipe=PIPE_FULL)
SP_REHEARSAL = dict(trials=96, lstm_dim=200, syn=SYN_REHEARSAL, pipe=PIPE_REHEARSAL)
CONV_KERNEL_WORDS = ("conv", "dgrad", "wgrad", "fprop", "xmma", "implicit", "cudnn")


def sp_close(got: float, want: float) -> bool:
    return abs(got - want) <= max(SP_ROW_RTOL * abs(want), SP_ROW_ATOL)


def sp_history_faults(label: str, got: list, want: list) -> list:
    """Rule above for two histories: lists of rows (sequences of numbers)."""
    if len(got) != len(want):
        return [f"{label}: {len(got)} epochs against the loop's {len(want)}"]
    return [f"{label} epoch {e} value {k}: {g[k]} against the loop's {w[k]}"
            for e, (g, w) in enumerate(zip(got, want)) for k in range(len(w))
            if not sp_close(g[k], w[k])]


def sp_worst(pairs) -> float:
    """The largest relative difference over (got, want) pairs."""
    return max((abs(g - w) / max(abs(w), 1e-30) for g, w in pairs), default=0.0)


def sp_rows(history: list) -> list:
    """A classifier history as rows of numbers (HISTORY_KEYS' order)."""
    from decode_tonal_langauge_tpu_torch.training.trainer import HISTORY_KEYS

    return [[row[k] for k in HISTORY_KEYS] for row in history]


def sp_by_epoch(got: list, want: list) -> list:
    """Each epoch's largest relative difference over every seed's row;
    ``got`` and ``want`` hold one history (rows of numbers) a seed."""
    worst = [sp_worst((g, w) for gh, wh in zip(got, want) for g, w in zip(gh[e], wh[e]))
             for e in range(min(len(h) for h in got + want))]
    return [float(f"{v:.3g}") for v in worst]


def sp_spread(got: list, want: list) -> tuple:
    """Two classifier fits' distance (SeedFitResults, seed by seed): the
    largest relative difference of their history values and each seed's
    test predictions flipped."""
    worst = sp_worst((g, w) for b, r in zip(got, want)
                     for gr, wr in zip(sp_rows(b.history), sp_rows(r.history))
                     for g, w in zip(gr, wr))
    return worst, [int((b.test_preds != r.test_preds).sum()) for b, r in zip(got, want)]


def sp_f64_steps(card: str, device: str, sz: dict, failures: list) -> None:
    """Two NAdam steps of SP_F64_SEEDS stacked seeds of each paper model in
    float64, dropout on (``seed_stack.SeedStack``, ``optim.SeedNAdam``: the
    trainers' batched step), against each seed's own two steps: every
    weight within SP_F64_ATOL of its tensor's largest (float64 puts the
    reordered sums ~1e9 below float32's, where no near-tie of these inputs
    is within reach; the parallel phase's argument)."""
    import copy

    import torch

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN
    from decode_tonal_langauge_tpu_torch.ops.dropout import set_dropout_generator
    from decode_tonal_langauge_tpu_torch.training.optim import NAdam, SeedNAdam
    from decode_tonal_langauge_tpu_torch.training.seed_stack import SeedStack
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import _l1_loss
    from decode_tonal_langauge_tpu_torch.training.trainer import _batch_loss

    rng = np.random.default_rng(15)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    syn = sz["syn"]
    cases = [(name, lambda name=name, k=k, kw=kw: get_classifier_by_name(
                  name, k, TRAIN_CHANNELS, TRAIN_LENGTH, kw),
              lambda k=k: [f64(rng.standard_normal((SP_F64_SEEDS, SP_F64_BATCH,
                                                    TRAIN_CHANNELS, TRAIN_LENGTH))),
                           torch.as_tensor(rng.integers(0, k, (SP_F64_SEEDS, SP_F64_BATCH)),
                                           device=device),
                           f64(np.ones((SP_F64_SEEDS, SP_F64_BATCH)))],
              1, lambda out, y, w: _batch_loss(out, y, w), TRAIN_LR, 0.01, False)
             for name, k, kw in (("CNN", N_SYLLS, {}),
                                 ("CNNRNN", N_TONES, {"lstm_dim": sz["lstm_dim"]}))]
    cases.append(("SynthesisFull",
                  lambda: SynthesisModelCNN(syn["n_mels"] * 20, syn["non"], SYN_LENGTH),
                  lambda: [f64(np.stack([a.numpy() for a in parts]))
                           for parts in zip(*(synthesis_batch(rng, SP_F64_BATCH, syn)
                                              for _ in range(SP_F64_SEEDS)))],
                  2, lambda out, y, w: _l1_loss(out, y, w, w.sum()), SYN_LR, SYN_DECAY, True))
    seeds = list(range(SP_F64_SEEDS))
    for name, make, batch_fn, n_in, loss_fn, lr, decay, decay_all in cases:
        models = [init_params(make(), s).double() for s in seeds]
        loops = [copy.deepcopy(m).to(device) for m in models]
        stack = SeedStack(models, torch.device(device))
        opt = SeedNAdam(list(stack.params.values()), lr, weight_decay=decay, decay_all=decay_all)
        gens = [torch.Generator(device=device).manual_seed(s) for s in seeds]
        loop_opts = [NAdam(m, lr, weight_decay=decay, decay_all=decay_all) for m in loops]
        for s, m in zip(seeds, loops):
            set_dropout_generator(m, torch.Generator(device=device).manual_seed(s))
        t0 = time.perf_counter()
        for _ in range(2):
            batch = batch_fn()
            inputs, targets = batch[:n_in], batch[n_in:]
            grads, _, _ = stack.grad_step(inputs, loss_fn, targets, gens)
            opt.step([grads[k] for k in stack.params])
            for i, (m, o) in enumerate(zip(loops, loop_opts)):
                loss = loss_fn(m.train()(*(x[i] for x in inputs)), *(t[i] for t in targets))
                o.step(torch.autograd.grad(loss, list(m.parameters())))
        worst = max(float((stack.state_dict(i)[k] - v.cpu()).abs().max())
                    / max(float(v.abs().max()), 1.0)
                    for i, m in enumerate(loops) for k, v in m.state_dict().items())
        if worst > SP_F64_ATOL:
            failures.append(f"{name} float64 steps: a weight {worst:.3g} of its tensor's "
                            f"largest from the seed's own")
        print(f"{name}, {SP_F64_SEEDS} seeds, 2 float64 NAdam steps at batch {SP_F64_BATCH} "
              f"(dropout on): batched weights "
              f"within {worst:.3g} of each seed's own (rule {SP_F64_ATOL:g}); "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        del models, loops, stack, opt, loop_opts
        if device == "cuda":
            torch.cuda.empty_cache()


def sp_conv_kernels(rows: list) -> list:
    """The convolution kernels among a step's device rows: (ms, count, name)."""
    return [r for r in rows if any(w in r[2].lower() for w in CONV_KERNEL_WORDS)]


def sp_print_steps(card: str, name: str, trials: int, batched: dict, loop: dict) -> None:
    """One batched step of every seed against the loop's steps of every
    seed, with the convolution kernels each picked."""
    for label, prof in (("batched", batched), ("loop", loop)):
        check(prof["rows"], f"torch.profiler saw no device time in a {name} {label} step")
        print_step(card, f"{name}, {SP_SEEDS} seeds, {label}", trials, prof, top=6)
        for ms, count, op in sp_conv_kernels(prof["rows"])[:8]:
            print(f"    conv  {ms:8.4f} ms  x{count:<6g} {op[:110]}")
    print(f"{name}: one batched step of {SP_SEEDS} seeds {batched['wall_ms']:.2f} ms against "
          f"{SP_SEEDS} loop steps {loop['wall_ms']:.2f} ms "
          f"({loop['wall_ms'] / batched['wall_ms']:.2f}x); device work "
          f"{batched['busy_ms']:.2f} vs {loop['busy_ms']:.2f} ms, operations "
          f"{batched['ops']:.0f} vs {loop['ops']:.0f}, peak {batched['peak_mib']:.0f} vs "
          f"{loop['peak_mib']:.0f} MiB [{card}]")


def sp_subject(sz: dict) -> dict:
    """The training phase's subject (``write_subject``), its first
    ``sz["trials"]`` trials."""
    with tempfile.TemporaryDirectory() as root:
        subject = write_subject(root, np.random.default_rng(0))
        data = dict(np.load(os.path.join(subject["dirs"]["samples"], "subject_1.npz")))
    n = sz["trials"]
    return {"ecog": data["ecog"][:n], "tone": data["tone"][:n], "syllable": data["syllable"][:n]}


def sp_stacks(subject: dict, target: str, seeds) -> list:
    """Each seed's split and standardisation as the stage makes them
    (``classifier_pipeline._seed_split``), stacked on the seed axis."""
    from argparse import Namespace

    from decode_tonal_langauge_tpu_torch.training.classifier_pipeline import _seed_split

    params = Namespace(train_ratio=0.7, vali_ratio=0.1, test_ratio=0.2, standardize=True)
    splits = [_seed_split(params, subject["ecog"], subject[target].astype(np.int32), s)[0]
              for s in seeds]
    return [np.stack(part) for part in zip(*splits)]


def sp_classifier_kw(n_classes: int, device: str) -> dict:
    return dict(n_classes=n_classes, learning_rate=TRAIN_LR, weight_decay=0.01,
                batch_size=TRAIN_BATCH, max_epochs=SP_EPOCHS, patience=60, device=device)


def sp_classifiers(card: str, device: str, subject: dict, seeds, sz: dict,
                   failures: list) -> dict:
    """Both paper classifiers, SP_SEEDS seeds x SP_EPOCHS epochs: the
    batched fit against the loop and the loop against itself under
    deterministic cuDNN (rows, flips, accuracies and walls printed; a
    seed whose epochs or stop differ goes to ``failures``), then one
    batched step against the loop's steps (card only). Returns the CNN's
    batched results, the sharded run's reference."""
    import torch

    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.training.seed_parallel import (
        SeedParallelTrainer,
        fit_seed,
    )
    from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    for name, target, n_classes, kwargs in (("CNN", "syllable", N_SYLLS, {}),
                                            ("CNNRNN", "tone", N_TONES,
                                             {"lstm_dim": sz["lstm_dim"]})):
        model_fn = lambda: get_classifier_by_name(  # noqa: E731
            name, n_classes, TRAIN_CHANNELS, TRAIN_LENGTH, kwargs)
        stacks = sp_stacks(subject, target, seeds)
        kw = sp_classifier_kw(n_classes, device)
        sync()
        t0 = time.perf_counter()
        batched = SeedParallelTrainer(model_fn(), seeds=seeds, **kw).fit_eval(*stacks)
        sync()
        batched_s = time.perf_counter() - t0
        loop = [fit_seed(ClassifierTrainer(model_fn(), seed=s, **kw), *(a[i] for a in stacks))
                for i, s in enumerate(seeds)]
        sync()
        loop_s = time.perf_counter() - t0 - batched_s
        # The loop once more under deterministic cuDNN: the same fit in
        # another float32 order of its sums, the yardstick for the rows.
        torch.backends.cudnn.deterministic = True
        try:
            other = [fit_seed(ClassifierTrainer(model_fn(), seed=s, **kw),
                              *(a[i] for a in stacks)) for i, s in enumerate(seeds)]
        finally:
            torch.backends.cudnn.deterministic = False
        worst, flips = sp_spread(batched, loop)
        worst_other, flips_other = sp_spread(other, loop)
        failures += [f"{name} seed {b.seed}: {len(b.history)} epochs, stop {b.stopped_early} "
                     f"against the loop's {len(w.history)}, {w.stopped_early}"
                     for b, w in zip(batched, loop)
                     if (len(b.history), b.stopped_early) != (len(w.history), w.stopped_early)]
        acc = lambda rs: [float(np.mean(r.test_preds == r.test_true)) for r in rs]  # noqa: E731
        by_epoch = lambda rs: sp_by_epoch([sp_rows(r.history) for r in rs],  # noqa: E731
                                          [sp_rows(r.history) for r in loop])
        final = lambda rs: [round(r.history[-1]["val/loss"], 4) for r in rs]  # noqa: E731
        print(f"{name} ({n_classes} {target} classes), {SP_SEEDS} seeds x {SP_EPOCHS} epochs "
              f"on {stacks[0].shape[1]} train trials at batch {TRAIN_BATCH}: batched fit "
              f"{batched_s:.2f} s against the loop's {loop_s:.2f} s "
              f"({loop_s / batched_s:.2f}x); rows within rel {worst:.3g} of the loop's (by "
              f"epoch {by_epoch(batched)}), test predictions flipped {flips} of "
              f"{stacks[4].shape[1]}; the loop under deterministic cuDNN: rows within rel "
              f"{worst_other:.3g} (by epoch {by_epoch(other)}), flipped {flips_other}; test "
              f"accuracy batched {acc(batched)}, loop {acc(loop)}, deterministic loop "
              f"{acc(other)}; final val/loss batched {final(batched)}, loop {final(loop)}, "
              f"deterministic {final(other)} [{card}]")
        out[name] = batched
        if not on_card:
            continue
        spt = SeedParallelTrainer(model_fn(), seeds=seeds, **kw)
        spt.init()
        x = torch.from_numpy(stacks[0][:, :TRAIN_BATCH]).to(device)
        y = torch.from_numpy(stacks[1][:, :TRAIN_BATCH].astype(np.int64)).to(device)
        w = torch.ones(y.shape, device=device)
        total = w.sum(dim=1)
        trainers = [ClassifierTrainer(model_fn(), seed=s, **kw) for s in seeds]
        for t in trainers:
            t.init()
        sp_print_steps(card, name, SP_SEEDS * TRAIN_BATCH,
                       step_profile(lambda: spt.train_step(x, y, w, total)),  # noqa: B023
                       step_profile(lambda: [t.train_step(x[i], y[i], w[i])  # noqa: B023
                                             for i, t in enumerate(trainers)]))  # noqa: B023
        del spt, trainers
        torch.cuda.empty_cache()
    return out


def sp_synthesizer(card: str, device: str, sz: dict, failures: list) -> None:
    """``train_synthesizer.run`` at the synthesizer phase's SynthesisFull
    widths with SP_SEEDS seeds, ``--seed_parallel 1`` against ``0``: each
    seed's loss and MCD per epoch and its test MCD by the rule, both walls;
    then (card only) two batched gradients of one batch equal under
    deterministic cuDNN, and one batched step against the loop's steps at
    batch 8."""
    import torch

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN
    from decode_tonal_langauge_tpu_torch.runtime.device import exact_f32
    from decode_tonal_langauge_tpu_torch.training import train_synthesizer as stage
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import (
        SeedSynthesisStack,
        SynthesisTrainer,
        _l1_loss,
    )

    on_card = device == "cuda"
    results = {}
    with tempfile.TemporaryDirectory() as root:
        world = write_synthesis_world(root, sz)
        for flag, fn_name in (("1", "seed_parallel_fit_eval"), ("0", "seed_loop_fit_eval")):
            real = getattr(stage, fn_name)
            got = []
            setattr(stage, fn_name, lambda *a, _real=real, **k: got.append(_real(*a, **k)) or got[-1])
            args = synthesizer_args(world["paths"], os.path.join(root, flag), device,
                                    "--repeat", str(SP_SEEDS), "--seed_parallel", flag)
            at = args.index("--checkpoint_dir")  # 4 x 407 MB not needed here
            del args[at:at + 2]
            try:
                t0 = time.perf_counter()
                summary = stage.run(stage.build_parser().parse_args(args))
                wall = time.perf_counter() - t0
            finally:
                setattr(stage, fn_name, real)
            check(len(got) == 1, f"--seed_parallel {flag}: {fn_name} ran {len(got)} times")
            results[flag] = (got[0], summary, wall)
    (batched, summary, b_wall), (loop, _, l_wall) = results["1"], results["0"]
    faults, pairs = [], []
    for seed, (bh, bmcd, _, _), (lh, lmcd, _, _) in zip(json.loads(summary["seeds"]),
                                                       batched, loop):
        faults += sp_history_faults(f"SynthesisFull seed {seed}", bh, lh)
        if not sp_close(bmcd, lmcd):
            faults.append(f"SynthesisFull seed {seed}: test MCD {bmcd} against the loop's {lmcd}")
        pairs += [(g, w) for gr, wr in zip(bh, lh) for g, w in zip(gr, wr)] + [(bmcd, lmcd)]
    failures += faults
    print(f"synthesizer stage, SynthesisFull, {SP_SEEDS} seeds x {SYN_EPOCHS} epochs at batch "
          f"{SYN_BATCH}: --seed_parallel 1 {b_wall:.2f} s against 0 {l_wall:.2f} s "
          f"({l_wall / b_wall:.2f}x; files and mels included); losses, MCDs and test MCDs "
          f"within rel {sp_worst(pairs):.3g} of the loop's (by epoch "
          f"{sp_by_epoch([r[0] for r in batched], [r[0] for r in loop])}); "
          f"test MCD {summary['mcd_all']}, the loop's {[round(r[1], 3) for r in loop]} "
          f"[{card}]")
    if not on_card:
        return
    mel_dim = sz["n_mels"] * 20
    frozen = [init_params(get_classifier_by_name(n, k, sz["cls"], SYN_LENGTH), seed=0)
              for n, k in (("CNNRNN", N_TONES), ("CNN", N_SYLLS))]
    proto = SynthesisTrainer(SynthesisModelCNN(mel_dim, sz["non"], SYN_LENGTH), *frozen,
                             world["config"]["tone_dynamic_mapping"], learning_rate=SYN_LR,
                             schedule_decay=SYN_DECAY, verbose=False, device=device)
    seeds = json.loads(summary["seeds"])
    fit = SeedSynthesisStack(proto, seeds)
    rng = np.random.default_rng(14)
    per_seed = [tuple(t.to(device) for t in synthesis_batch(rng, SYN_BATCH, sz))
                for _ in seeds]
    batch = [torch.stack(parts) for parts in zip(*per_seed)]
    total = batch[3].sum(dim=1)
    def grads():  # one batched backward from the same weights and masks
        gens = [torch.Generator(device=device).manual_seed(s) for s in seeds]
        with exact_f32(deterministic=True):
            return fit.stack.grad_step(batch[:2], _l1_loss, (*batch[2:], total), gens)[0]

    first, second = grads(), grads()
    check(all(torch.equal(first[k], second[k]) for k in first),
          "SynthesisFull: two batched gradients of one batch differ under deterministic cuDNN")
    print("SynthesisFull, 4 seeds batched (grouped convolutions) under deterministic cuDNN: two "
          "gradients of one batch equal bit for bit")
    del first, second
    trainers = [proto.for_seed(s) for s in seeds]
    for t in trainers:
        t.init()
    sp_print_steps(card, "SynthesisFull", SP_SEEDS * SYN_BATCH,
                   step_profile(lambda: fit.train_step(*batch, total)),
                   step_profile(lambda: [t.train_step(*b) for t, b in zip(trainers, per_seed)]))
    del fit, trainers
    torch.cuda.empty_cache()


def sp_fast_bf16(card: str, device: str, sz: dict) -> None:
    """``configs/fast_bf16.yaml`` through the runner (``bf16_pipeline``'s
    subject and cut) with ``seed_parallel`` on and off: each run's
    evaluation rows equal to its training rows; the test predictions
    flipped between the runs and both walls printed."""
    import shutil

    from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject

    spec = SyntheticSpec(n_channels=sz["channels"], ecog_sf=PIPE_SF, n_blocks=2,
                         trials_per_block=sz["trials_per_block"])
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        write_subject(f"{root}/on/raw", 1, spec)
        shutil.copytree(f"{root}/on/raw", f"{root}/off/raw")
        for flag in ("on", "off"):
            config = bf16_pipeline_config(f"{root}/{flag}", sz)
            config["training"]["params"]["training"]["seed_parallel"] = flag == "on"
            outputs, fits, wall, _, k1 = run_recorded_pipeline(config, device)
            check(k1 == 0, f"K1 launched during fast_bf16 with seed_parallel {flag}")
            rows = read_csv(os.path.join(outputs["training"], "results.csv"))
            check(read_csv(os.path.join(outputs["evaluation"], "results.csv")) == rows,
                  f"fast_bf16, seed_parallel {flag}: evaluation rows differ from training's")
            runs[flag] = (fits, rows, wall)
    (on, on_rows, on_wall), (off, off_rows, off_wall) = runs["on"], runs["off"]
    check(sorted(on) == sorted(off), f"fast_bf16 targets {sorted(on)} and {sorted(off)}")
    flips = {t: {s: int((on[t][s] != off[t][s]).sum()) for s in on[t]} for t in on}
    print(f"fast_bf16 pipeline, {BF16_SEEDS} seeds x {BF16_EPOCHS} epochs: seed_parallel on "
          f"{on_wall:.2f} s against off {off_wall:.2f} s ({off_wall / on_wall:.2f}x, all stages);"
          f" evaluation rows equal to training's in both; test predictions flipped per target "
          f"and seed {flips}; accuracy_all on "
          + ", ".join(f"{r['target']} {r['accuracy_all']}" for r in on_rows)
          + "; off " + ", ".join(f"{r['target']} {r['accuracy_all']}" for r in off_rows)
          + f" [{card}]")


def sp_sharded_fit(task: dict, mesh, device: str) -> list:
    """A rank's part of the sharded run: the CNN's batched fit with the
    seed axis over the mesh, under deterministic cuDNN; each seed's
    history, best epoch, stop, test predictions and a hash of its weights."""
    import hashlib

    import torch

    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.training.seed_parallel import SeedParallelTrainer

    data = np.load(task["stacks"])
    stacks = [data[f"a{i}"] for i in range(6)]
    torch.backends.cudnn.deterministic = True
    try:
        results = SeedParallelTrainer(
            get_classifier_by_name("CNN", N_SYLLS, TRAIN_CHANNELS, TRAIN_LENGTH),
            seeds=task["seeds"], mesh=mesh, seed_chunk=task.get("seed_chunk"),
            **sp_classifier_kw(N_SYLLS, device)).fit_eval(*stacks)
    finally:
        torch.backends.cudnn.deterministic = False
    return [(r.seed, r.history, r.best_epoch, r.stopped_early, r.test_preds.tolist(),
             hashlib.sha1(b"".join(v.numpy().tobytes() for v in r.params.values())).hexdigest())
            for r in results]


def sp_sharded(card: str, device: str, subject: dict, seeds, batched: list) -> None:
    """Two ranks sharing the card over gloo, the CNN's SP_SEEDS seeds
    sharded over them (one batched fit of SP_SEEDS / 2 seeds a rank, no
    collective a step, the results gathered): every rank's rows, test
    predictions and weights equal to one process's batched fit of the same
    seed blocks (``seed_chunk``); its distance from the unchunked fit
    printed (float32: another grouping of the seeds sums in another
    order)."""
    with tempfile.TemporaryDirectory() as root:
        stacks_path = os.path.join(root, "stacks.npz")
        np.savez(stacks_path, **{f"a{i}": a for i, a in
                                 enumerate(sp_stacks(subject, "syllable", seeds))})
        task = {"stacks": stacks_path, "seeds": seeds}
        outs, wall = par_launch(os.path.join(root, "launch"), 2, {
            "device": device, "backend": "gloo", "sizes": {}, "steps": False,
            "seed_fit": task})
        want = sp_sharded_fit({**task, "seed_chunk": SP_SEEDS // 2}, None, device)
    for rank, out in enumerate(outs):
        check(out["seed_fit"] == want, f"sharded seeds, rank {rank}: rows, predictions or "
              "weights differ from one process's fit of the same seed blocks")
        check(out["k1"] == 0, f"K1 launched on rank {rank} of the sharded run")
    worst, flips = sp_spread([
        type(b)(seed=s, history=h, best_epoch=be, stopped_early=st, test_true=b.test_true,
                test_preds=np.asarray(p), n_params=b.n_params)
        for (s, h, be, st, p, _), b in zip(want, batched)], batched)
    print(f"sharded seeds: 2 gloo ranks sharing the card, {SP_SEEDS} CNN seeds, "
          f"{SP_SEEDS // 2} a rank: rows, test predictions and weights on both ranks equal to "
          f"one process's fit of the same seed blocks; against the unchunked fit rows within "
          f"rel {worst:.3g}, predictions flipped {flips}; launch {wall:.1f} s [{card}]")


def seed_parallel_phase(card: str, device: str = "cuda", sizes: dict = SP_FULL) -> None:
    """The batched step in float64; SP_SEEDS seeds of the paper's
    classifiers and of SynthesisFull, the batched fit against the loop;
    fast_bf16 with seed_parallel on and off; the seed axis sharded over two
    gloo ranks; K1's launches (none). The rows' faults are reported after
    every part has run.
    ``device="cpu", sizes=SP_REHEARSAL`` rehearses it on a CPU (no step
    timings, no sharded run)."""
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream

    cuda_iir.LAUNCHES = 0
    seeds = [int(s) for s in seed_stream(42, SP_SEEDS)]
    subject = sp_subject(sizes)
    failures = []  # the rows' faults, reported after every part has run
    sp_f64_steps(card, device, sizes, failures)
    with one_torch_thread():  # the sharded run's ranks draw the weights on one thread
        batched = sp_classifiers(card, device, subject, seeds, sizes, failures)
        if device == "cuda":
            sp_sharded(card, device, subject, seeds, batched["CNN"])
    sp_synthesizer(card, device, sizes["syn"], failures)
    sp_fast_bf16(card, device, sizes["pipe"])
    print(f"K1 launches during the seed-parallel phase: {cuda_iir.LAUNCHES}")
    check(cuda_iir.LAUNCHES == 0, "K1 launched during the seed-parallel phase")
    check(not failures, f"{len(failures)} rows off the rule: " + "; ".join(failures[:12]))


# The parallel phase: the multi-device layer (``parallel/``) on the card.
# (a) one rank over NCCL: a train step of each paper model through the
#     data-parallel layout (a mesh of one rank, its all-reduce real) equals
#     the plain step bit for bit under deterministic cuDNN;
# (b) two ranks sharing the one card over gloo (NCCL refuses two ranks on
#     one card; the layer's collectives are all-reduce and broadcast, which
#     gloo runs on CUDA tensors, staged through the host): two NAdam steps
#     of each model at the global batch against the same two steps in one
#     process, by the rule below;
# (c) the pipeline runner on 2 ranks over a 2-subject narrowing of the
#     pipeline phase's subject (host_shard: one subject a rank): the merged
#     results.csv rows equal the one-process run's, evaluation's equal
#     training's;
# (d) serving --parallel_data 2: ids equal to the one-process decode, mels
#     within 1e-5;
# (e) with two or more cards, (b)'s steps over NCCL, one rank per card.
# Every spawned launch has a timeout; a rank that fails or hangs fails the
# phase. The rule for (b) and (e): a data-parallel step differs from the
# one-process step by the order of its sums alone (each rank sums its slice
# of the batch, the all-reduce adds the slices, and the convolutions pick
# their algorithms for the slice's shape). In float32 that rounding is
# carried far into the weights: a max-pool window whose two largest inputs
# lie within rounding of each other routes its gradient to either one (the
# training phase's BranchTape), and NAdam's early steps, about lr times the
# sign of each gradient element, turn the last digits of a near-zero
# gradient into a full step either way (a CPU rehearsal of SynthesisFull
# moved whole tensors' updates 2-4% and one weight 4.9 lr). So the float32
# steps are held by their losses (rtol 1e-4, STEP_LOSS_TOL's) and timed,
# and the same two steps run in float64 are held tight: float64 puts the
# rounding ~1e9 times lower, where no near-tie or near-zero gradient of
# these seeded inputs is within reach, so the losses agree within rtol 1e-9
# and every weight within 1e-9 of the one-process float64 weight, a million
# times above float64's rounding of these steps and a million times below
# one NAdam step (5e-4), which any wrong reduction (a slice counted twice
# or divided by its own weight instead of the global batch's, other dropout
# masks) moves many weights by.
PAR_LOSS_RTOL, PAR_F64_RTOL, PAR_F64_ATOL = 1e-4, 1e-9, 1e-9
PAR_MEL_ATOL = 1e-5
PAR_TIMEOUT_S = 600
PAR_FULL = dict(lstm_dim=800, syn=SYN_FULL,
                pipe=dict(channels=32, trials_per_block=48, lstm_dim=800))
PAR_REHEARSAL = dict(lstm_dim=200, syn=SYN_REHEARSAL, pipe=PIPE_REHEARSAL)


def par_models(sz: dict) -> dict:
    """name -> (trainer factory taking ``mesh, device, dtype``, batch
    factory taking ``device, dtype``): the full-width CNN (8 syllables)
    and CNN-RNN (4 tones) at batch 32 and SynthesisFull at batch 8,
    dropout on, seeded weights and batches (the same in either dtype)."""
    import torch

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.models.simple import LogisticRegressionClassifier
    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import SynthesisTrainer
    from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

    def classifier(name, n_classes, kwargs):
        def make(mesh, device, dtype):
            model = get_classifier_by_name(name, n_classes, TRAIN_CHANNELS, TRAIN_LENGTH,
                                           kwargs).to(dtype)
            t = ClassifierTrainer(model, n_classes, learning_rate=TRAIN_LR, weight_decay=0.01,
                                  batch_size=TRAIN_BATCH, seed=3, device=device, mesh=mesh)
            t.init()
            return t

        def batch(device, dtype):
            rng = np.random.default_rng(1)
            x = rng.standard_normal((TRAIN_BATCH, TRAIN_CHANNELS, TRAIN_LENGTH)).astype(np.float32)
            w = np.ones(TRAIN_BATCH, np.float32)
            w[-5:] = 0.0  # a padded batch: the slices' weights differ
            return (torch.tensor(x, device=device).to(dtype),
                    torch.tensor(rng.integers(0, n_classes, TRAIN_BATCH), device=device),
                    torch.tensor(w, device=device).to(dtype))
        return make, batch

    syn = sz["syn"]
    mel_dim = syn["n_mels"] * 20

    def synthesis(mesh, device, dtype):
        dummy = [init_params(LogisticRegressionClassifier(syn["cls"] * SYN_LENGTH, k), 0)
                 for k in (N_TONES, N_SYLLS)]
        mapping = {str(k): list(np.linspace(0, 1, syn["n_dyn"])) for k in range(N_TONES)}
        model = SynthesisModelCNN(mel_dim, syn["non"], SYN_LENGTH).to(dtype)
        t = SynthesisTrainer(model, *dummy,
                             mapping, learning_rate=SYN_LR, schedule_decay=SYN_DECAY, seed=4,
                             verbose=False, device=device, mesh=mesh)
        t.init()
        return t

    def synthesis_batch_on(device, dtype):
        return tuple(t.to(device, dtype) for t in synthesis_batch(np.random.default_rng(11),
                                                                  SYN_BATCH, syn))

    return {"CNN": classifier("CNN", N_SYLLS, {}),
            "CNNRNN": classifier("CNNRNN", N_TONES, {"lstm_dim": sz["lstm_dim"]}),
            "SynthesisFull": (synthesis, synthesis_batch_on)}


def par_steps(trainer, batch, n: int = 2) -> list:
    """``n`` train steps of ``trainer`` on this rank's rows of the global
    ``batch`` (the last tensor its weights); returns the losses."""
    rows = trainer._layout.rows(batch[0].shape[0])
    total = batch[-1].sum()
    return [trainer.train_step(*(t[rows] for t in batch), total)[0].item() for _ in range(n)]


def par_step_profile(trainer, batch, device: str) -> dict:
    """Wall ms of one step (median of 3 after the compared ones), its peak
    device memory, and from torch.profiler over one step: the collectives'
    host ms (``all_reduce`` events; gloo stages through the host, so this
    is its whole time) and device ms (NCCL's kernels, gloo's copies), and
    the device's busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        par_steps(trainer, batch, 1)
        sync()
        walls.append(time.perf_counter() - t0)
    peak = float("nan")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        par_steps(trainer, batch, 1)
        sync()
        peak = torch.cuda.max_memory_allocated() / 2**20
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        par_steps(trainer, batch, 1)
        sync()
    host = dev = busy = 0.0
    for e in prof.key_averages():
        d = (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)) / 1e3
        on_device = "CUDA" in str(getattr(e, "device_type", ""))  # kernels, copies
        busy += d if on_device else 0.0
        if "allreduce" in e.key.lower().replace("_", ""):
            if on_device:
                dev += d
            else:
                host += e.cpu_time_total / 1e3
    return {"step_ms": float(np.median(walls)) * 1e3, "allreduce_host_ms": host,
            "allreduce_device_ms": dev, "busy_ms": busy, "peak_mib": peak,
            "allreduce_ms": par_allreduce_ms(trainer, device)}


def par_allreduce_ms(trainer, device: str) -> float:
    """The all-reduce of a step's gradient buffer (every parameter, the
    step's own dtype) over the ``data`` group alone, after a barrier: ms a
    call, 5 back to back after 2 warm-ups (CUDA events on the card; the
    host clock on a CPU). NaN without a mesh. The all-reduce events inside
    a profiled step also count the wait for the slowest rank."""
    import torch
    import torch.distributed as dist

    from decode_tonal_langauge_tpu_torch._timing import time_ms
    from decode_tonal_langauge_tpu_torch.parallel.distributed import barrier

    layout = trainer._layout
    if layout.mesh is None:
        return float("nan")
    params = list(trainer.model.parameters())
    buf = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype, device=device)
    call = lambda: dist.all_reduce(buf, group=layout.group)  # noqa: E731
    barrier("allreduce timing")
    if device == "cuda":
        return time_ms(call, warmup=2, runs=5)
    call()
    t0 = time.perf_counter()
    for _ in range(5):
        call()
    return (time.perf_counter() - t0) / 5 * 1e3


def par_model_run(make, batch_fn, mesh, device: str, dtype, profile: bool) -> dict:
    """Two steps of one model in ``dtype`` under ``mesh`` (None: one
    process) from its seeded weights, under deterministic cuDNN: losses,
    final weights (CPU), a checksum of them, and (``profile``) the step's
    times."""
    import torch

    trainer = make(mesh, device, dtype)
    batch = batch_fn(device, dtype)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        losses = par_steps(trainer, batch)
        end = trainer.params
        out = {"losses": losses, "end": end,
               "checksum": float(sum(v.double().abs().sum() for v in end.values()))}
        if profile:
            out.update(par_step_profile(trainer, batch, device))
    return out


def par_faults(name: str, got32: dict, want32: dict, got64: dict, want64: dict) -> list:
    """Where a data-parallel run breaks the rule above against the
    one-process runs; empty when it holds. Sets ``got64["worst"]``, the
    largest weight difference in float64."""
    faults = []
    if not np.allclose(got32["losses"], want32["losses"], rtol=PAR_LOSS_RTOL, atol=0):
        faults.append(f"{name} float32 losses {got32['losses']} vs one process "
                      f"{want32['losses']}")
    if not np.allclose(got64["losses"], want64["losses"], rtol=PAR_F64_RTOL, atol=0):
        faults.append(f"{name} float64 losses {got64['losses']} vs one process "
                      f"{want64['losses']}")
    worst = ("", 0.0)
    for k, ref in want64["end"].items():
        diff = (got64["end"][k] - ref).abs().max().item()
        worst = max(worst, (k, diff), key=lambda kv: kv[1])
        if not diff <= PAR_F64_ATOL:
            faults.append(f"{name} {k}: float64 weights {diff:.3g} from one process's")
    got64["worst"] = worst
    return faults


def par_pipeline_config(root: str, sz: dict) -> dict:
    """The pipeline phase's config over two synthetic subjects."""
    import copy

    cfg = pipeline_config(root, sz)
    pipe = cfg["preprocess"]["params"]["pipeline"]["params"]
    pipe["subject_dirs"], pipe["subject_ids"] = ["Sub1", "Sub2"], [1, 2]
    subjects = cfg["sample_collection"]["params"]["subjects"]
    subjects[2] = copy.deepcopy(subjects[1])
    subjects[2]["textgrid_dir"] = "annotations/subject_2"
    return cfg


def par_pipeline_world(root: str, sz: dict) -> dict:
    from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject

    spec = SyntheticSpec(n_channels=sz["channels"], ecog_sf=PIPE_SF, n_blocks=2,
                         trials_per_block=sz["trials_per_block"])
    for sid in (1, 2):
        write_subject(f"{root}/raw", sid, spec)
    return par_pipeline_config(root, sz)


def par_pipeline_rows(outputs: dict) -> tuple:
    key = lambda r: (r["subject"], r["target"])  # noqa: E731
    return (sorted(read_csv(os.path.join(outputs["training"], "results.csv")), key=key),
            sorted(read_csv(os.path.join(outputs["evaluation"], "results.csv")), key=key))


def parallel_worker(spec_path: str) -> None:
    """One rank of a ``torch.distributed.run`` launch of this script
    (``--parallel-worker <spec.json>``): the steps of each model under a
    mesh over every rank (unless ``steps`` is false), and optionally the
    seed-parallel phase's sharded fit, the 2-subject pipeline and the
    serving CLI; writes ``rank<k>.pt`` beside the spec."""
    import datetime

    import torch
    import torch.distributed as dist

    from decode_tonal_langauge_tpu_torch import pipeline, serving
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.parallel import distributed
    from decode_tonal_langauge_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    distributed.initialize(backend=spec["backend"], device=device,
                           timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    rank, world = distributed.process_index(), distributed.process_count()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cuda_iir.LAUNCHES = 0
    mesh = make_mesh(world)
    out = {"world": world, "backend": dist.get_backend(), "steps": {}}
    for name, (make, batch_fn) in (par_models(spec["sizes"]).items()
                                   if spec.get("steps", True) else ()):
        f64 = par_model_run(make, batch_fn, mesh, device, torch.float64, profile=False)
        f32 = par_model_run(make, batch_fn, mesh, device, torch.float32, profile=True)
        f32.pop("end")
        if rank:
            f64.pop("end")
        out["steps"][name] = {"f32": f32, "f64": f64}
    if spec.get("seed_fit"):
        out["seed_fit"] = sp_sharded_fit(spec["seed_fit"], mesh, device)
    if spec.get("pipeline"):
        torch.backends.cudnn.deterministic = True  # the reference run's setting
        t0 = time.perf_counter()
        outputs = pipeline.run_pipeline(spec["pipeline"], device=None if on_card else device)
        out["pipeline"] = {"outputs": outputs, "wall_s": time.perf_counter() - t0}
        torch.backends.cudnn.deterministic = False
    if spec.get("serving"):
        t0 = time.perf_counter()
        out["serving"] = {"summary": serving.run(serving.build_parser().parse_args(
            spec["serving"])), "wall_s": time.perf_counter() - t0}
    out["k1"] = cuda_iir.LAUNCHES
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20 if on_card else float("nan")
    torch.save(out, os.path.join(os.path.dirname(spec_path), f"rank{rank}.pt"))
    distributed.barrier("worker:done")
    dist.destroy_process_group()


def par_launch(root: str, n: int, spec: dict) -> list:
    """``python -m torch.distributed.run --standalone --nproc_per_node n
    chip_smoke.py --parallel-worker`` with ``spec``; fails the run if the
    launch exits non-zero or outlasts PAR_TIMEOUT_S (its processes are
    then killed). Returns each rank's outputs and the launch's wall s."""
    import signal

    import torch

    os.makedirs(root, exist_ok=True)
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__), "--parallel-worker",
           spec_path]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=PAR_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{n}-rank launch outlasted {PAR_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(log[-6000:])
        fail(f"{n}-rank launch exited {proc.returncode}")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(n)], wall


def par_check_steps(card: str, label: str, outs: list, ref: dict) -> None:
    """(b)/(e): each model's data-parallel steps by the rule against the
    one-process ``ref``, equal weights and losses on every rank, and the
    step's times."""
    for name, want in ref.items():
        got = outs[0]["steps"][name]
        faults = par_faults(name, got["f32"], want["f32"], got["f64"], want["f64"])
        check(not faults, f"{label}: {'; '.join(faults)}")
        for dt in ("f32", "f64"):
            sums = [o["steps"][name][dt]["checksum"] for o in outs]
            check(len(set(sums)) == 1, f"{label} {name} {dt}: ranks hold different weights "
                  f"{sums}")
            check(all(o["steps"][name][dt]["losses"] == got[dt]["losses"] for o in outs),
                  f"{label} {name} {dt}: ranks report different losses")
        g, w = got["f32"], want["f32"]
        print(f"{label} {name}: float32 losses {g['losses']} vs one process {w['losses']}; "
              f"float64 weights within {got['f64']['worst'][1]:.2g} of one process's "
              f"({got['f64']['worst'][0]}); step "
              + ", ".join(f"rank {r} {o['steps'][name]['f32']['step_ms']:.2f} ms"
                          for r, o in enumerate(outs))
              + f" (one process {w['step_ms']:.2f} ms); the gradients' all-reduce alone "
              f"{g['allreduce_ms']:.3f} ms; in the profiled step all-reduce "
              f"{g['allreduce_host_ms']:.2f} ms host, {g['allreduce_device_ms']:.3f} ms "
              f"device, device busy {g['busy_ms']:.2f} ms; peak "
              + ", ".join(f"rank {r} {o['steps'][name]['f32']['peak_mib']:.0f}"
                          for r, o in enumerate(outs))
              + f" MiB (one process {w['peak_mib']:.0f}) [{card}]")


@contextlib.contextmanager
def one_torch_thread():
    """One CPU thread for torch, as each launched rank has
    (``OMP_NUM_THREADS=1``): the seeded weights go through a CPU QR (the
    LSTMs' orthogonal kernels, ``models.base.init_params``) whose last bits
    follow the thread count, so the one-process references must draw them
    as the ranks do."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def parallel_phase(card: str, device: str = "cuda", sizes: dict = PAR_FULL) -> None:
    """(a)-(e) above; K1 must launch 0 times in every process.
    ``device="cpu", sizes=PAR_REHEARSAL`` rehearses it on a CPU (gloo for
    (a) too)."""
    with one_torch_thread():
        _parallel_phase(card, device, sizes)


def _parallel_phase(card: str, device: str, sizes: dict) -> None:
    import torch
    import torch.distributed as dist

    from decode_tonal_langauge_tpu_torch import serving
    from decode_tonal_langauge_tpu_torch.ops import cuda_iir
    from decode_tonal_langauge_tpu_torch.parallel import distributed
    from decode_tonal_langauge_tpu_torch.parallel.mesh import make_mesh

    on_card = device == "cuda"
    cuda_iir.LAUNCHES = 0
    models = par_models(sizes)
    with tempfile.TemporaryDirectory() as root:
        # (a) one rank, NCCL on the card.
        t0 = time.perf_counter()
        distributed.initialize(f"file://{root}/store1", 1, 0, device=device)
        backend = dist.get_backend()
        mesh = make_mesh(1)
        ref = {}
        for name, (make, batch_fn) in models.items():
            plain = par_model_run(make, batch_fn, None, device, torch.float32, profile=True)
            meshed = par_model_run(make, batch_fn, mesh, device, torch.float32, profile=True)
            same = plain["losses"] == meshed["losses"] and all(
                torch.equal(plain["end"][k], meshed["end"][k]) for k in plain["end"])
            check(same, f"(a) {name}: the one-rank {backend} layout's step differs from the "
                  "plain step")
            print(f"(a) {name}: one rank over {backend}, the layout's 2 steps equal the plain "
                  f"steps bit for bit; step {meshed['step_ms']:.2f} ms with the layout, "
                  f"{plain['step_ms']:.2f} ms plain, the gradients' all-reduce alone "
                  f"{meshed['allreduce_ms']:.3f} ms, in the step "
                  f"{meshed['allreduce_host_ms']:.2f} ms host / "
                  f"{meshed['allreduce_device_ms']:.3f} ms device; busy "
                  f"{meshed['busy_ms']:.2f} / {plain['busy_ms']:.2f} ms of the profiled step, "
                  f"peak {meshed['peak_mib']:.0f} / {plain['peak_mib']:.0f} MiB [{card}]")
            ref[name] = {"f32": plain, "f64": par_model_run(make, batch_fn, None, device,
                                                            torch.float64, profile=False)}
        dist.destroy_process_group()
        print(f"(a) {time.perf_counter() - t0:.1f} s")

        # The one-process references of (c) and (d).
        t0 = time.perf_counter()
        pipe_cfg = par_pipeline_world(f"{root}/one", sizes["pipe"])
        torch.backends.cudnn.deterministic = True
        try:
            one_out, _, one_wall, _, k1 = run_recorded_pipeline(pipe_cfg, device)
        finally:
            torch.backends.cudnn.deterministic = False
        check(k1 == 0, "K1 launched during the one-process pipeline run")
        one_rows, _ = par_pipeline_rows(one_out)
        os.makedirs(f"{root}/serving_art")
        art = write_artifacts(f"{root}/serving_art", np.random.default_rng(0))
        serve_args = lambda out: cli_args(art["paths"], out, device, stream=False) + [  # noqa: E731
            "--n_wavs", "0"]
        serving.run(serving.build_parser().parse_args(serve_args(f"{root}/served_one")))
        print(f"one-process references of (c) and (d): {time.perf_counter() - t0:.1f} s "
              f"(pipeline {one_wall:.1f} s)")

        # (b), (c), (d): two ranks sharing the card over gloo, one launch.
        par_pipeline_world(f"{root}/two", sizes["pipe"])
        spec = {"device": device, "backend": "gloo", "sizes": sizes,
                "pipeline": par_pipeline_config(f"{root}/two", sizes["pipe"]),
                "serving": serve_args(f"{root}/served_two") + ["--parallel_data", "2"]}
        outs, wall = par_launch(f"{root}/launch2", 2, spec)
        check([o["world"] for o in outs] == [2, 2] and outs[0]["backend"] == "gloo",
              f"the 2-rank launch ran {[o['world'] for o in outs]} ranks over "
              f"{outs[0]['backend']}")
        print(f"(b)-(d) 2-rank launch over gloo on one card: {wall:.1f} s wall; peak over the "
              "launch (float64 steps and the pipeline included) "
              + ", ".join(f"rank {r} {o['peak_mib']:.0f} MiB" for r, o in enumerate(outs))
              + f" [{card}]")
        par_check_steps(card, "(b) 2 ranks, gloo", outs, ref)

        two_rows, two_eval = par_pipeline_rows(outs[0]["pipeline"]["outputs"])
        check(len(two_rows) == 6 and {r["subject"] for r in two_rows} == {"1", "2"},
              f"(c) merged rows {[(r['subject'], r['target']) for r in two_rows]}")
        check(two_rows == one_rows, "(c) the 2-rank pipeline's merged rows differ from the "
              "one-process run's")
        check(two_eval == two_rows, "(c) the 2-rank evaluation rows differ from training's")
        print(f"(c) pipeline on 2 ranks, 2 subjects: {outs[0]['pipeline']['wall_s']:.1f} s "
              f"(one process {one_wall:.1f} s); merged rows equal the one-process rows, "
              "evaluation's equal training's; accuracy_mean "
              + ", ".join(f"{r['subject']}/{r['target']} {r['accuracy_mean']}"
                          for r in two_rows) + f" [{card}]")

        preds = {k: read_csv(f"{root}/served_{k}/predictions.csv") for k in ("one", "two")}
        check(preds["one"] == preds["two"], "(d) served ids differ from the one-process decode")
        mels = {k: np.load(f"{root}/served_{k}/mels.npz")["mel"] for k in ("one", "two")}
        err = float(np.abs(mels["one"] - mels["two"]).max())
        check(mels["one"].shape == mels["two"].shape and err <= PAR_MEL_ATOL,
              f"(d) served mels differ by {err}")
        print(f"(d) serving --parallel_data 2: {len(preds['two'])} trials, ids equal to the "
              f"one-process decode, mels max abs diff {err:.3g}; "
              f"{outs[0]['serving']['wall_s']:.2f} s wall [{card}]")
        k1 = cuda_iir.LAUNCHES + sum(o["k1"] for o in outs)

        # (e) one rank per card over NCCL.
        n_cards = torch.cuda.device_count() if on_card else 0
        if n_cards >= 2:
            k1 += nccl_ranks(card, f"{root}/launch{n_cards}", n_cards, sizes, ref)
        else:
            print(f"(e) skipped: {n_cards if on_card else 'no'} card visible, NCCL needs "
                  "one rank per card")
    print(f"K1 launches during the parallel phase: {k1}")
    check(k1 == 0, "K1 launched during the parallel phase")


def nccl_ranks(card: str, root: str, n: int, sizes: dict, ref: dict) -> int:
    """(e): the models' steps on ``n`` ranks, one per card, over NCCL,
    against the one-process ``ref``; returns the ranks' K1 launches."""
    outs, wall = par_launch(root, n, {"device": "cuda", "backend": "nccl", "sizes": sizes})
    check([o["world"] for o in outs] == [n] * n and outs[0]["backend"] == "nccl",
          f"the {n}-rank launch ran {[o['world'] for o in outs]} ranks over "
          f"{outs[0]['backend']}")
    print(f"(e) {n}-rank launch over NCCL, one rank a card: {wall:.1f} s wall; peak over the "
          "launch (float64 steps included) "
          + ", ".join(f"rank {r} {o['peak_mib']:.0f} MiB" for r, o in enumerate(outs))
          + f" [{card}]")
    par_check_steps(card, f"(e) {n} ranks, NCCL", outs, ref)
    return sum(o["k1"] for o in outs)


def nccl_phase(card: str, sizes: dict = PAR_FULL) -> None:
    """(e) alone, with its one-process references: for a machine with
    several cards."""
    import torch

    n = torch.cuda.device_count()
    check(n >= 2, f"nccl_phase needs two or more cards, {n} visible")

    with one_torch_thread():
        ref = {name: {"f32": par_model_run(make, batch_fn, None, "cuda", torch.float32, True),
                      "f64": par_model_run(make, batch_fn, None, "cuda", torch.float64, False)}
               for name, (make, batch_fn) in par_models(sizes).items()}
    with tempfile.TemporaryDirectory() as root:
        k1 = nccl_ranks(card, f"{root}/launch{n}", n, sizes, ref)
    check(k1 == 0, "K1 launched during the NCCL ranks")


# The demo phase: scripts/demo_end_to_end_torch.py, the port's one-command
# demo, at its own widths (12 channels, 2 x 48 trials at 400 Hz, logistic +
# shallow MLP, SynthesisLite, n_mels 16). Each glob under its workdir and
# the files it matches; DEMO_FILES counts every file but figures and
# TensorBoard event files (the card's machine has neither matplotlib nor
# tensorboardX).
DEMO_LAYOUT = {
    "raw/Sub1/HS1-B*/raw.npz": 2,
    "raw/annotations/subject_1/B*.TextGrid": 2,
    "processed/*/subject_1/B*_*.npz": 4,
    "samples/*__*/subject_1.npz": 1,
    "channel_selection/*/subject_1.json": 1,
    "logs/logistic__*/results.csv": 1,
    "logs/logistic__*/evaluation/results.csv": 1,
    "logs/logistic__*/model_checkpoints/*": 4,
    "logs/logistic__*/*_csv/subject_1/seed_*/metrics.csv": 4,
    "synth/results.csv": 1,
    "synth/ckpt/SynthesisLite_seed_*": 1,
    "synth/wavs/*.wav": 20,
    "decoded/predictions.csv": 1,
    "decoded/mels.npz": 1,
    "decoded/decoded_*.wav": 2,
    "streamed/windows.csv": 1,
    "streamed/events.csv": 1,
    "streamed/mels.npz": 1,
    "streamed/decoded_w*.wav": 1,
}
DEMO_FILES = 68
DEMO_SR = 800


def demo_check_files(root: str) -> None:
    """The layout, every CSV's numbers finite, the WAVs' rate and count,
    evaluation's rows equal to training's."""
    import glob
    import importlib.util

    from scipy.io import wavfile

    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, names in os.walk(root) for f in names)
    figures = [f for f in files if f.endswith(".png")]
    events = [f for f in files if os.path.basename(f).startswith("events.out.tfevents.")]
    for pattern, n in DEMO_LAYOUT.items():
        got = glob.glob(os.path.join(root, pattern))
        check(len(got) == n and all(os.path.isfile(p) for p in got),
              f"demo: {len(got)} files match {pattern}, not {n}")
    check(len(files) - len(figures) - len(events) == DEMO_FILES,
          f"demo: {len(files) - len(figures) - len(events)} files, not {DEMO_FILES}")
    if importlib.util.find_spec("matplotlib") is None:
        check(not figures, f"demo: figures without matplotlib: {figures[:3]}")
    for rel in (f for f in files if f.endswith(".csv")):
        for row in read_csv(os.path.join(root, rel)):
            for key, value in row.items():
                try:
                    number = float(value)
                except (TypeError, ValueError):
                    continue
                check(np.isfinite(number), f"demo: {rel} {key} = {value}")
    wavs = [f for f in files if f.endswith(".wav")]
    for rel in wavs:
        rate, wave = wavfile.read(os.path.join(root, rel))
        check(rate == DEMO_SR and wave.size > 0 and np.isfinite(wave).all(),
              f"demo: {rel} rate {rate}, {wave.size} samples")
    (logs,) = glob.glob(os.path.join(root, "logs", "logistic__*"))
    check(read_csv(os.path.join(logs, "evaluation", "results.csv"))
          == read_csv(os.path.join(logs, "results.csv")),
          "demo: evaluation rows differ from training's")
    print(f"demo files: {len(files)} ({len(figures)} figures, {len(events)} TensorBoard files), "
          f"{len(wavs)} WAVs at {DEMO_SR} Hz, every CSV finite, evaluation rows equal "
          f"to training's")


def demo_card_vs_cpu(root: str, run: dict, device: str) -> None:
    """The demo's checkpoints loaded on the CPU through the flags the
    serving CLI recovered from the training run, decoding the demo's
    epochs: ids equal to the card's ``decoded/`` where the top-2 margin
    exceeds 1e-4, mels within rtol/atol 1e-3 (the serving phase's rules)."""
    from decode_tonal_langauge_tpu_torch import serving

    path = lambda rel: os.path.join(root, rel)  # noqa: E731
    sample = path(os.path.join(run["outputs"]["sample_collection"], "subject_1.npz"))
    params = serving.build_parser().parse_args(
        ["--sample_path", sample, "--training_dir", path(run["outputs"]["training"]),
         "--config_file", path("synth_config.json"), "--synthesis_model_name",
         "SynthesisLite", "--synthesis_model_path", path(run["synth_ckpt"]),
         "--output_dir", path("decoded_cpu"), "--device", "cpu"])
    serving._configure_from_training_dir(params)
    with open(path(os.path.join(run["outputs"]["channel_selection"], "subject_1.json"))) as f:
        channels = json.load(f)
    with open(params.config_file) as f:
        config = json.load(f)
    ecog = np.load(sample)["ecog"]
    decoder = serving.load_decoder(
        channels, config, ecog.shape[2], params.tone_model_name, params.tone_model_path,
        params.syllable_model_name, params.syllable_model_path,
        synthesis_model_name="SynthesisLite", synthesis_model_path=params.synthesis_model_path,
        tone_model_kwargs=params.tone_model_kwargs,
        syllable_model_kwargs=params.syllable_model_kwargs, device="cpu")
    ref = decoder.decode(ecog, channels)
    rows = read_csv(path("decoded/predictions.csv"))
    check(len(rows) == ecog.shape[0], f"demo: {len(rows)} decoded rows for {ecog.shape[0]}")
    for key in ("tone", "syllable"):
        got = np.array([int(r[f"{key}_pred"]) for r in rows])
        top2 = np.sort(ref[f"{key}_probs"], axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-4
        check((got[clear] == ref[key][clear]).all(),
              f"demo: {key} ids differ between {device} and cpu on "
              f"{int((got[clear] != ref[key][clear]).sum())} trials")
        print(f"demo {key}: ids equal on {int(clear.sum())}/{len(got)} trials with a clear "
              f"top-2 margin ({device} vs cpu)")
    mel = np.load(path("decoded/mels.npz"))["mel"]
    check(mel.shape == ref["mel"].shape and np.allclose(mel, ref["mel"], rtol=1e-3, atol=1e-3),
          f"demo: mels differ: {mel.shape} vs {ref['mel'].shape}, "
          f"{np.abs(mel - ref['mel']).max() if mel.shape == ref['mel'].shape else 'n/a'}")
    print(f"demo mel {mel.shape}: max abs diff {np.abs(mel - ref['mel']).max():.3g} "
          f"({device} vs cpu)")


def demo_phase(card: str, device: str = "cuda") -> None:
    """``scripts/demo_end_to_end_torch.py`` in this process on the card
    (its default device) in a fresh directory: K1's launches, the files,
    the card's epoch decode against the CPU's on the demo's checkpoints,
    and each step's wall."""
    import importlib.util

    from decode_tonal_langauge_tpu_torch.ops import cuda_iir

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "demo_end_to_end_torch.py")
    spec = importlib.util.spec_from_file_location("demo_end_to_end_torch", script)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "demo_run")
        argv = [root] + ([] if device == "cuda" else ["--device", device])
        cuda_iir.LAUNCHES = 0
        t0 = time.perf_counter()
        run = demo.main(argv)
        wall = time.perf_counter() - t0
        k1 = cuda_iir.LAUNCHES
        print(f"K1 launches during the demo phase: {k1}")
        check(k1 == 0, "K1 launched during the demo")
        stream = run["stream"]
        check(stream["n_windows"] > 0 and len(read_csv(os.path.join(
            root, "streamed", "windows.csv"))) == stream["n_windows"],
            f"demo: stream summary {stream}")
        check(run["epochs"]["n_trials"] == 96, f"demo: epoch summary {run['epochs']}")
        demo_check_files(root)
        demo_card_vs_cpu(root, run, device)
        walls = ", ".join(f"{k} {v:.2f} s" for k, v in run["walls"].items())
        print(f"demo steps: {walls}; main() {wall:.2f} s; tone accuracy "
              f"{run['epochs']['tone_accuracy']:.3f}, syllable "
              f"{run['epochs']['syllable_accuracy']:.3f}, synthesis MCD "
              f"{run['synthesizer']['mcd_mean']:.1f}, {stream['n_windows']} windows, "
              f"{stream['n_events']} events [{card}]")


def main() -> None:
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--parallel-worker"]:  # a rank of the parallel phase
        parallel_worker(sys.argv[2])
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    try:
        from decode_tonal_langauge_tpu_torch import _build
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    from decode_tonal_langauge_tpu_torch.ops import cuda_iir

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    kernels = [timed(k1_phase, card)]
    timed(preprocess_phase, card)
    timed(training_phase, card)
    timed(seed_parallel_phase, card)
    timed(synthesis_phase, card)
    cuda_iir.LAUNCHES = 0
    timed(serving_phase, card)
    print(f"K1 launches during the serving phase: {cuda_iir.LAUNCHES}")
    timed(pipeline_phase, card)
    timed(bf16_phase, card)
    timed(parallel_phase, card)
    timed(demo_phase, card)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
