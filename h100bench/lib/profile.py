"""Reading ``torch.profiler``'s events: the device operations of a window
of whole requests, their union, and the idle gaps by what the host did.

The method is ``chip_smoke.py``'s ``device_ms``: kernel durations as
CUPTI records them (also inside CUDA-graph replays).  The busy time is the
union of the device operations' intervals, not their sum, so overlapping
operations count once.  The events stay in memory; nothing is written.
"""

import contextlib
import heapq

#: The name of the benchmark's own span around each call it profiles.
SPAN = "h100bench.request"


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over the block (CPU and CUDA activity); yields a
    list that receives a :class:`Trace` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out.append(Trace(prof))


def span():
    """The benchmark's span around one profiled call."""
    from torch.profiler import record_function

    return record_function(SPAN)


def _union(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """The events of one profiled block: ``spans`` (the benchmark's request
    spans), ``device`` (every device operation) and ``host`` (every other
    host event), each a list of ``(name, start_ns, end_ns)``."""

    def __init__(self, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.spans, self.device, self.host = [], [], []
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns()
            row = (e.name(), a, a + e.duration_ns())
            if e.device_type() == cuda:
                # The profiler mirrors each span onto the device's timeline
                # as an annotation, which is no device operation.
                if e.name() != SPAN and not getattr(e, "is_user_annotation", lambda: False)():
                    self.device.append(row)
            elif e.name() == SPAN:
                self.spans.append(row)
            else:
                self.host.append(row)
        self.spans.sort(key=lambda r: r[1])

    def window_s(self):
        """Seconds inside the request spans."""
        return _union([(a, b) for _, a, b in self.spans]) / 1e9

    def _clipped(self, rows):
        out = []
        for name, a, b in rows:
            for _, s, e in self.spans:
                lo, hi = max(a, s), min(b, e)
                if hi > lo:
                    out.append((name, lo, hi))
        return out

    def busy_s(self):
        """Seconds inside the spans in which some device operation ran."""
        return _union([(a, b) for _, a, b in self._clipped(self.device)]) / 1e9

    def device_s(self, match):
        """Summed seconds of the device operations whose name ``match``
        accepts, inside the spans."""
        return sum(b - a for name, a, b in self._clipped(self.device) if match(name)) / 1e9

    def top_ops(self, k=10):
        """The ``k`` device operations (by name) that took the most time."""
        by = {}
        for name, a, b in self._clipped(self.device):
            by[name] = by.get(name, 0) + b - a
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k=10):
        """Idle device time inside the spans, by the innermost host event
        that covered each gap's midpoint (the span itself where none did):
        the ``k`` names with the most idle time."""
        busy = sorted((a, b) for _, a, b in self._clipped(self.device))
        gaps = []
        for _, s, e in self.spans:
            t = s
            for a, b in busy:
                if b <= s or a >= e:
                    continue
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if t < e:
                gaps.append((t, e))
        host = sorted(self.host, key=lambda r: r[1])
        by, j, active = {}, 0, []
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while j < len(host) and host[j][1] <= mid:
                heapq.heappush(active, (-host[j][1], host[j][2], host[j][0]))
                j += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)  # ended: it covers no later midpoint
            name = active[0][2] if active else SPAN
            by[name] = by.get(name, 0) + b - a
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda r: -r[1])[:k]]
