"""The decode's share of the card's float32 peak: the configuration's
analytic forward FLOPs of one window (both classifiers and the
synthesizer, ``flops/<config>.py``) times the windows decoded a second in
the run's measured window, over 67 TFLOP/s (TF32 is off)."""


def read(m):
    return 100.0 * m.flops.forward_flops_per_window(m.cfg) * m.window["rate"] / m.peaks.F32_FLOPS
