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
3. Serving phase at the paper's widths (CNN-RNN tone and CNN syllable
   models on 6 channels each, SynthesisLite on 20, 200-sample epochs,
   4 tones, 8 syllables, mel_dim 2560, Griffin-Lim at sr 24414 with n_fft
   2048, hop 512, 32 iterations) with seeded random weights: the serving
   CLI in epoch mode (32 trials, 4 waves) and stream mode (60 s at 400 Hz,
   window 200, hop 40: 596 windows), then the same epoch decode on the
   card and on the CPU, which must agree. Prints trials/s, windows/s and
   waves/s beside the card's name and power limit.
4. Prints the ``kernels`` JSON line, then the final ``ok`` JSON line.
"""

from __future__ import annotations

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

    kernels = [k1_phase(card)]
    serving_phase(card)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
