"""Time the three-pass ``iir_df2t`` CUDA kernel over chunk length, rows,
length and filter.

    python scripts/k1_sweep.py

Needs one CUDA card. Two sweeps, one JSON line per configuration:

1. the chunk length L in {128, 256, 512, 1024} at the main-path shape
   (128 rows x 183,120 samples, order-8 Butterworth band, steady-state
   initial state), each with its max abs error against SciPy in float64;
2. rows, length and filter at the default ``CHUNK``.

Each configuration sets ``cuda_iir.CHUNK`` before it runs. Each line has
the kernel's time (``ms``, the sum of its three passes) and each pass's
time, from ``torch.profiler`` over 20 calls (the script stops if the
profiler sees no device time); the time of one wrapper call made back
to back with 50 others, host work included (``call_ms``; 2,000 calls in
the first configuration, while ``nvidia-smi`` samples the SM clock and
power draw); the bytes bound (x read once, y written once, at
3.35 TB/s); whether the output is finite (the order-16 band,
``butter(8, ...)``, diverges in f32 in any DF2T form, and its time is
that of garbage); and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import scipy.signal as sps

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAIN = (128, 183120, "band4")  # rows, samples, filter (butter(4) band: order 8)
CHUNKS = (128, 256, 512, 1024)
CONFIGS = [  # at the default chunk length
    (128, 183120, "band1"),
    (128, 183120, "band4"),
    (128, 183120, "band8"),
    (128, 183120, "fir20"),  # order 19: the generic instance
    (128, 45780, "band4"),
    (1024, 183120, "band4"),
    (16896, 45780, "band4"),
]


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def design(name: str):
    if name == "fir20":
        return sps.firwin(20, 0.3), np.array([1.0])
    return sps.butter(int(name[4:]), [0.1, 0.4], btype="bandpass")


def measure(cuda_iir, b, a, x, zi, chunk: int, sample_clocks: bool) -> dict:
    import torch

    from decode_tonal_langauge_tpu_torch.runtime.profiling import kernel_ms, time_ms

    cuda_iir.CHUNK = chunk

    def call():
        return cuda_iir.lfilter_cuda(b, a, x, zi=zi)

    out = call()
    sampler = None
    if sample_clocks:
        sampler = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm,"
             "power.draw", "--format=csv,noheader", "-lms", "100"],
            stdout=subprocess.PIPE, text=True,
        )
    try:
        call_ms = time_ms(call, runs=2000 if sample_clocks else 50)
    finally:
        clocks = None
        if sampler is not None:
            sampler.terminate()
            clocks = sampler.communicate(timeout=60)[0].strip().splitlines()
    pass_ms = kernel_ms(call, cuda_iir.PASS_KERNELS)
    if pass_ms is None:
        sys.exit("k1_sweep: torch.profiler saw no device time for a pass")
    rows, t = x.shape
    return {
        "ms": sum(pass_ms), "pass_ms": pass_ms,
        "call_ms": call_ms,
        "bound_ms": 4 * (2 * rows * t + 2 * rows * zi.shape[1]) / 3.35e12 * 1e3,
        "finite": bool(torch.isfinite(out[0]).all().item()),
        "smi_during_run": clocks, "out": out,
    }


def main() -> None:
    import torch

    from decode_tonal_langauge_tpu_torch.ops import cuda_iir

    if not torch.cuda.is_available():
        sys.exit("k1_sweep: needs a CUDA card")
    card = smi("name,power.limit")
    rng = np.random.default_rng(0)

    rows, t, name = MAIN
    b, a = design(name)
    default_chunk = cuda_iir.CHUNK
    x_np = rng.standard_normal((rows, t)).astype(np.float32)
    zi_np = sps.lfilter_zi(b, a)[None] * x_np[:, :1].astype(np.float64)
    ref_y, ref_zf = sps.lfilter(b, a, x_np.astype(np.float64), zi=zi_np, axis=-1)
    x = torch.from_numpy(x_np).cuda()
    zi = torch.from_numpy(zi_np.astype(np.float32)).cuda()
    for i, chunk in enumerate(CHUNKS):
        r = measure(cuda_iir, b, a, x, zi, chunk, sample_clocks=i == 0)
        y, zf = (v.cpu().numpy() for v in r.pop("out"))
        err = max(np.abs(y - ref_y).max(), np.abs(zf - ref_zf).max())
        print(json.dumps({"sweep": "chunk", "chunk": chunk, "rows": rows,
                          "samples": t, "filter": name, "order": len(a) - 1,
                          **r, "max_abs_err_vs_scipy": float(err), "card": card}))
    del x, zi

    for rows, t, name in CONFIGS:
        b, a = design(name)
        order = max(len(a), len(b)) - 1
        x = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32)).cuda()
        zi = torch.zeros((rows, order), device="cuda")
        r = measure(cuda_iir, b, a, x, zi, default_chunk, sample_clocks=False)
        r.pop("out")
        print(json.dumps({"sweep": "shape", "chunk": default_chunk, "rows": rows,
                          "samples": t, "filter": name, "order": order, **r,
                          "card": card}))
        del x, zi


if __name__ == "__main__":
    main()
