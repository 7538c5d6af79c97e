"""The program's own spans in a profiled block: device-idle time by the
phase the host was in.

The port marks its phases with profiler ranges named ``gpar.*``
(``gpar_torch/utils/spans.py``), which reach a
:class:`~h100bench.lib.profile.Trace` among its ``host`` events, on the
clock of its device operations.  The device-idle time inside the request
spans (what ``device_idle`` reads) is cut at the program spans' boundaries,
and each piece goes to the innermost program span that covers it, or to
:data:`OUTSIDE` where none does: each span's self idle.  A program without
such spans gives every idle piece to :data:`OUTSIDE`, and the readers of
these numbers then return None.
"""

import bisect
import heapq

#: The prefix of the program's span names.
PREFIX = "gpar."
#: Where idle time under no program span goes.
OUTSIDE = "outside"


def program_spans(trace, name=None):
    """The program's spans, ``(name, start_ns, end_ns)`` by start; only
    those called ``name`` if given."""
    rows = [r for r in trace.host if r[0].startswith(PREFIX) and (name is None or r[0] == name)]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_intervals(trace):
    """The device-idle intervals inside the request spans, disjoint and
    sorted: the request spans less the device operations' union."""
    windows = _merged([(a, b) for _, a, b in trace.spans])
    busy = _merged([(a, b) for _, a, b in trace.device])
    out, j = [], 0
    for s, e in windows:
        t = s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            a, b = busy[k]
            if a > t:
                out.append((t, a))
            t = max(t, b)
            k += 1
        if t < e:
            out.append((t, e))
    return out


def self_idle_ns(trace):
    """``{span name: ns}``: each idle piece given to the innermost program
    span covering it (the latest started of those still open), the rest
    to :data:`OUTSIDE`.  The values sum to the idle time inside the
    request spans."""
    spans = program_spans(trace)
    cuts = sorted({t for _, a, b in spans for t in (a, b)})
    out, j, active = {}, 0, []
    for ga, gb in idle_intervals(trace):
        lo, hi = bisect.bisect_right(cuts, ga), bisect.bisect_left(cuts, gb)
        points = [ga, *cuts[lo:hi], gb]
        for a, b in zip(points, points[1:]):
            while j < len(spans) and spans[j][1] <= a:
                name, s, e = spans[j]
                heapq.heappush(active, (-s, e, name))  # a tie in start: the shorter is inner
                j += 1
            while active and active[0][1] <= a:
                heapq.heappop(active)  # ended: it covers no later piece
            name = active[0][2] if active else OUTSIDE
            out[name] = out.get(name, 0) + b - a
    return out


def idle_inside_ns(trace, name):
    """Idle ns inside the spans called ``name``, their children's included;
    None where the program has no such span."""
    mine = _merged([(a, b) for _, a, b in program_spans(trace, name)])
    if not mine:
        return None
    total, j = 0, 0
    for ga, gb in idle_intervals(trace):
        while j < len(mine) and mine[j][1] <= ga:
            j += 1
        k = j
        while k < len(mine) and mine[k][0] < gb:
            total += max(0, min(gb, mine[k][1]) - max(ga, mine[k][0]))
            k += 1
    return total


def per_request_ms(ns, ctx):
    """``ns`` in ms per profiled request; None without a trace or ``ns``."""
    if ns is None or ctx.trace is None or not ctx.traced:
        return None
    return ns / 1e6 / len(ctx.traced)
