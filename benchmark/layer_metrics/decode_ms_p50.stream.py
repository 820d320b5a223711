"""The median host-clock time of ``TonalDecoder.decode`` on one window,
results on the host, over the measured window's windows."""

import statistics


def read(m):
    spans = m.spans.get("decode")
    return 1e3 * statistics.median(spans) if spans else None
