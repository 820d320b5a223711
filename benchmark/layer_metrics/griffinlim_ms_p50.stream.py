"""The median host-clock time of ``TonalDecoder.synthesize_wavs`` (NNLS
and Griffin-Lim) on one window's mel, waveform on the host, over the
measured window's windows."""

import statistics


def read(m):
    spans = m.spans.get("griffinlim")
    return 1e3 * statistics.median(spans) if spans else None
