"""The whole train step's share of the card's float32 peak: the
configuration's analytic FLOPs of one trial's forward and backward
(``flops/<config>.py``) times the real trials (all seeds) stepped a
second in the run's measured window, over 67 TFLOP/s (float32 outside
the tensor cores; TF32 is off). The card's power limit is in the
result's ``device``."""


def read(m):
    return 100.0 * m.flops.train_flops_per_trial(m.cfg) * m.window["rate"] / m.peaks.F32_FLOPS
