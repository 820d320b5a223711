"""The port's layer spans in a trace, and the device work launched under
each.

The port marks its layer boundaries with ``torch.profiler.record_function``
spans (``decode_tonal_langauge_tpu_torch/runtime/profiling.py``), which a
trace taken with the host's ops holds as ``user_annotation`` events named
``<layer>.<part>`` (the harness's own annotations start with ``bench.``
and are left out). Each device event (kernel, copy, memset) is put under
the innermost port span that holds the host op that launched it (its
``External id``): a span on the op's own thread first; where that thread
holds none, the innermost span on any thread that holds the op's time.
The second rule is for the ops of a CUDA backward, which autograd runs on
a thread of its own: their enclosing step stays on the main thread.

A span's launches are the device events under it or under a span inside
it on the same thread. A trace without port spans (a program that has
none) reads nothing.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

from .trace import Trace

HARNESS_PREFIX = "bench."


class Spans:
    """The port spans of ``trace`` (a :class:`Trace` of host and device
    events) and the owner of each of its device events."""

    def __init__(self, trace: Trace) -> None:
        self.trace = trace
        self.spans: List[Dict] = [e for e in trace.host if e.get("cat") == "user_annotation"
                                  and not e["name"].startswith(HARNESS_PREFIX)]
        by_thread: Dict = defaultdict(list)
        for i, s in enumerate(self.spans):
            by_thread[s.get("tid")].append(i)
        self._by_thread = dict(by_thread)
        # the chain of each device event's owner: the owner, then the spans
        # holding it on its thread, outward (empty where none owns it)
        self.chains: List[List[int]] = [self._chain(e) for e in trace.device]

    def _holding(self, indices, t0: float, t1: float) -> List[int]:
        """Of ``indices``, the spans whose interval holds [t0, t1],
        innermost first."""
        held = [i for i in indices
                if self.spans[i]["ts"] <= t0 and t1 <= self.spans[i]["ts"] + self.spans[i]["dur"]]
        return sorted(held, key=lambda i: self.spans[i]["dur"])

    def _chain(self, event: Dict) -> List[int]:
        op = self.trace.ops_by_id.get(event.get("args", {}).get("External id"))
        if op is None or not self.spans:
            return []
        t0, t1 = op["ts"], op["ts"] + op.get("dur", 0)
        chain = self._holding(self._by_thread.get(op.get("tid"), []), t0, t1)
        if chain:
            return chain
        anywhere = self._holding(range(len(self.spans)), t0, t1)
        if not anywhere:
            return []
        owner = anywhere[0]
        s = self.spans[owner]
        return self._holding(self._by_thread[s.get("tid")], s["ts"], s["ts"] + s["dur"])

    def names(self) -> set:
        return {s["name"] for s in self.spans}

    def under(self, keep: Callable[[str], bool]) -> List[Dict]:
        """The device events under a span whose name ``keep`` accepts."""
        return [e for e, chain in zip(self.trace.device, self.chains)
                if any(keep(self.spans[i]["name"]) for i in chain)]

    def owner_name(self, k: int) -> Optional[str]:
        """The name of device event ``k``'s innermost span, or None."""
        chain = self.chains[k]
        return self.spans[chain[0]]["name"] if chain else None


def _detail(m) -> Optional[Spans]:
    """The port spans of a run's trace of one unit with the host's ops."""
    trace = getattr(m, "detail_trace", None)
    return Spans(trace) if trace is not None else None


def launches(m, keep: Callable[[str], bool]) -> Optional[float]:
    """Device events a traced unit launches under the spans ``keep``
    accepts; None where the trace holds no such span."""
    spans = _detail(m)
    if spans is None or not any(keep(n) for n in spans.names()):
        return None
    return len(spans.under(keep)) / spans.trace.units


def device_ms(m, keep: Callable[[str], bool]) -> Optional[float]:
    """Their device milliseconds a traced unit; None as :func:`launches`."""
    spans = _detail(m)
    if spans is None or not any(keep(n) for n in spans.names()):
        return None
    return sum(e["dur"] for e in spans.under(keep)) / 1e3 / spans.trace.units
