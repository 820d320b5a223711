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
   CNN and CNN-RNN on the card against the CPU and float64 (the losses,
   the first gradient and the weights, at the tolerances stated at
   STEP_LOSS_TOL); prints
   the stage wall, peak device memory, each model's median train-step
   time and trials/s, and the device work of one step (busy share,
   operations, the top ones from ``torch.profiler``); K1 must launch 0
   times.
5. Serving phase at the paper's widths (CNN-RNN tone and CNN syllable
   models on 6 channels each, SynthesisLite on 20, 200-sample epochs,
   4 tones, 8 syllables, mel_dim 2560, Griffin-Lim at sr 24414 with n_fft
   2048, hop 512, 32 iterations) with seeded random weights: the serving
   CLI in epoch mode (32 trials, 4 waves) and stream mode (60 s at 400 Hz,
   window 200, hop 40: 596 windows), then the same epoch decode on the
   card and on the CPU, which must agree. Prints trials/s, windows/s and
   waves/s beside the card's name and power limit.
6. Prints the ``kernels`` JSON line, then the final ``ok`` JSON line.
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
# steps in float32 on the card, in float32 on the CPU and in float64 on the
# card. The losses of the two float32 runs agree within STEP_LOSS_TOL. The
# first gradient and the weights after two steps are held by how far each
# float32 run lies from the float64 one (relative L2 distance, per tensor):
# the card's lies no farther than the CPU's, or within F64_FLOOR. Card and
# CPU are not compared element by element: max-pooling routes each
# gradient to the largest element of a window, and near-ties follow the
# rounding of the convolution below, so one window routed otherwise in a
# late pool puts every earlier layer's gradient ~1.5e-3 from float64;
# NAdam's first step is ~lr times the sign of each gradient element, so an
# element whose gradient float32 cannot resolve moves a few lr the other
# way, and the biases (zero at the start) end up a few percent from
# float64. Such tensors are held to the CPU's own distance. The floor,
# 1e-4, is a fifth of TF32's unit roundoff (4.9e-4): a control run,
# the same two steps on the card with TF32 allowed in cuDNN and cuBLAS,
# must fail this rule, or the rule could not tell float32 from TF32.
STEP_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
F64_FLOOR = 1e-4


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


def two_steps(model, batch, precision) -> dict:
    """Two NAdam steps of the trainer's loss (``train_step`` in the model's
    own dtype, its forward and backward inside ``precision()``): the first
    gradient, the losses and the final weights."""
    import torch

    from decode_tonal_langauge_tpu_torch.training.optim import NAdam
    from decode_tonal_langauge_tpu_torch.training.trainer import _batch_loss

    names, weights = zip(*model.named_parameters())
    opt = NAdam(weights, TRAIN_LR, weight_decay=0.01)
    model.train()
    first, losses = None, []
    for _ in range(2):
        with precision():
            loss = _batch_loss(model(batch[0]), batch[1], batch[2])
            grads = torch.autograd.grad(loss, weights)
        first = first or {k: g.cpu().double() for k, g in zip(names, grads)}
        opt.step(grads)
        losses.append(loss.item())
    end = {k: v.detach().cpu().double() for k, v in zip(names, weights)}
    return {"grads": first, "losses": losses, "end": end}


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


def distance(run: dict, exact: dict, key: str) -> dict:
    """Relative L2 distance of each tensor of ``run[key]`` from float64's."""
    return {k: (v - exact[key][k]).norm().item() / max(exact[key][k].norm().item(), 1e-30)
            for k, v in run[key].items()}


def parity_faults(run: dict, cpu_run: dict, exact: dict) -> list:
    """Where ``run`` breaks the card-vs-CPU rule (see STEP_LOSS_TOL): the
    losses, then each tensor of the first gradient and of the weights
    after two steps; empty when it holds."""
    faults = []
    if not np.allclose(run["losses"], cpu_run["losses"], **STEP_LOSS_TOL):
        faults.append(f"losses {run['losses']} vs cpu {cpu_run['losses']}")
    for key, what in (("grads", "first gradient"), ("end", "weights after 2 steps")):
        mine, cpus = distance(run, exact, key), distance(cpu_run, exact, key)
        faults += [f"{what} {k}: {mine[k]:.3g} from float64, cpu {cpus[k]:.3g}"
                   for k in mine if mine[k] > max(cpus[k], F64_FLOOR)]
    return faults


def step_parity(card: str, device: str) -> dict:
    """Card vs CPU: the full-width CNN and CNN-RNN (dropout 0) from the
    same seeded weights on one batch of 32, two NAdam steps on the card,
    on the CPU and in float64 on the card, and the TF32 control on the
    card. Returns card trainers and the batch for the timings."""
    import copy

    import torch

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
    from decode_tonal_langauge_tpu_torch.runtime.device import exact_f32
    from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

    rng = np.random.default_rng(1)
    x = rng.standard_normal((TRAIN_BATCH, TRAIN_CHANNELS, TRAIN_LENGTH)).astype(np.float32)
    out = {}
    for name, n_classes, kwargs in (("CNN", N_SYLLS, {"dropout_rate": 0.0}),
                                    ("CNNRNN", N_TONES, {"lstm_dim": 800, "dropout": 0.0})):
        y = torch.from_numpy(rng.integers(0, n_classes, TRAIN_BATCH))
        model = init_params(get_classifier_by_name(
            name, n_classes, TRAIN_CHANNELS, TRAIN_LENGTH, kwargs), seed=3)
        runs = {}
        for key, dev, dtype, precision in (
                ("card", device, torch.float32, exact_f32),
                ("cpu", "cpu", torch.float32, exact_f32),
                ("f64", device, torch.float64, exact_f32),
                ("tf32", device, torch.float32, tf32_allowed)):
            if key == "tf32" and device != "cuda":
                continue  # TF32 exists on the card only
            batch = (torch.from_numpy(x).to(dev, dtype), y.to(dev),
                     torch.ones(TRAIN_BATCH, device=dev, dtype=dtype))
            runs[key] = two_steps(copy.deepcopy(model).to(dev, dtype), batch, precision)
        cpu_run, exact = runs["cpu"], runs["f64"]
        print(f"{name} card vs cpu at batch {TRAIN_BATCH}, 2 NAdam steps: losses "
              f"{runs['card']['losses']} vs {cpu_run['losses']} (float64 {exact['losses']}"
              + (f", TF32 control {runs['tf32']['losses']}" if "tf32" in runs else "")
              + f") [{card}]")
        for key, what in (("grads", "first gradient"), ("end", "weights after 2 steps")):
            dist = {run: distance(runs[run], exact, key) for run in runs if run != "f64"}
            print(f"  {what}, relative L2 distance from float64 ({' / '.join(dist)}): "
                  + ", ".join(f"{k} " + "/".join(f"{d[k]:.2g}" for d in dist.values())
                              for k in dist["card"]))
            held = [k for k, v in dist["cpu"].items() if v > F64_FLOOR]
            print(f"    held to the cpu's distance (cpu above {F64_FLOOR:g}): "
                  f"{', '.join(held) or 'none'}")
        faults = parity_faults(runs["card"], cpu_run, exact)
        check(not faults, f"{name}: the card breaks the step rule: {'; '.join(faults)}")
        if "tf32" in runs:
            control = parity_faults(runs["tf32"], cpu_run, exact)
            print(f"  TF32 control breaks the rule on {len(control)} of "
                  f"{1 + 2 * len(exact['grads'])} counts, as it must: {'; '.join(control[:4])}")
            check(bool(control), f"{name}: the TF32 control passes the step rule, "
                  "which therefore cannot tell float32 from TF32")
        trainer = ClassifierTrainer(copy.deepcopy(model), n_classes, learning_rate=TRAIN_LR,
                                    weight_decay=0.01, batch_size=TRAIN_BATCH, seed=3,
                                    device=device)
        trainer.init()
        out[name] = (trainer, (torch.from_numpy(x).to(device), y.to(device),
                               torch.ones(TRAIN_BATCH, device=device)))
    return out


def train_step_times(card: str, trainers: dict) -> None:
    """Median train-step wall time (host clock around synchronize, after a
    warm-up) and trials/s per model at batch 32; the device work of one
    step from torch.profiler: busy share, launches, top operations."""
    import torch

    from decode_tonal_langauge_tpu_torch._timing import device_events

    for name, (trainer, batch) in trainers.items():
        step = lambda: trainer.train_step(*batch)  # noqa: E731
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_ms = float(np.median(walls)) * 1e3
        rows = device_events(step, runs=3)
        check(rows, f"torch.profiler saw no device time in a {name} train step")
        busy_ms = sum(r[0] for r in rows)
        launches = sum(r[1] for r in rows)
        print(f"{name} train step, batch {TRAIN_BATCH}: {wall_ms:.2f} ms (median of 10), "
              f"{TRAIN_BATCH / (wall_ms / 1e3):.1f} trials/s; device work {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}% busy), {launches:.0f} device operations "
              f"a step [{card}]")
        for ms, n, op in rows[:8]:
            print(f"    {ms:8.4f} ms  x{n:<6g} {op[:100]}")


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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

    kernels = [k1_phase(card)]
    preprocess_phase(card)
    training_phase(card)
    cuda_iir.LAUNCHES = 0
    serving_phase(card)
    print(f"K1 launches during the serving phase: {cuda_iir.LAUNCHES}")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
