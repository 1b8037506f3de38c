"""Reading a ``torch.profiler`` trace of the card: the device's busy time in
the window (the union of every kernel, copy and set on the card), its
operations by time, and its idle gaps by what the host was doing then (the
harness's own spans: ``step``, ``checkpoint.snapshot``,
``checkpoint.wait_for_previous_save``; anything else is the loop around
them: the reader's queue, the host-to-device copy of a batch).

The trace's device times are moved onto the host clock by a marker kernel
(``torch.cuda._sleep``) launched at a known host time.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import torch

LOOP = "loop (reader, batch to device)"


def start():
    """A running profiler of the card's activity, and the host time at
    which its marker kernel was launched."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    import time
    t = time.time_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return prof, t


def _device_events(prof) -> Tuple[List[Tuple[str, int, int]], Optional[int]]:
    """The device's events ``(name, start, ns)``, and how many kernel
    launches the host made whose device record the trace lacks (matched by
    CUPTI's correlation id; None where the trace holds no launch)."""
    out, launched, ran = [], set(), set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
            ran.update((e.correlation_id(), e.linked_correlation_id()))
        elif "launchkernel" in e.name().lower():
            launched.add(e.correlation_id())
    return out, (len(launched - ran) if launched else None)


def read(prof, marker_ns: int, t0_ns: int, t1_ns: int,
         spans: List[Tuple[str, int, int]]) -> Optional[Dict]:
    """→ ``kernels`` [(name, ns)] of the whole trace, ``lost_launches``
    (see ``_device_events``), ``busy_s`` and ``window_s`` of ``[t0_ns,
    t1_ns)`` on the host clock, ``device_ops`` and ``idle_gaps`` (at most
    10 each, seconds). None if the trace holds no device event."""
    events, lost = _device_events(prof)
    if not events:
        return None
    mark = [s for n, s, _ in events if "sleep" in n.lower() or "spin" in n.lower()]
    offset = marker_ns - min(mark) if mark else 0
    iv = sorted((max(s + offset, t0_ns), min(s + d + offset, t1_ns)) for _, s, d in events)
    merged: List[List[int]] = []
    for a, b in iv:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = {}
    for n, s, d in events:
        if t0_ns <= s + offset < t1_ns:
            by_name[n[:80]] = by_name.get(n[:80], 0.0) + d / 1e9
    gaps = []
    prev = t0_ns
    for a, b in merged + [[t1_ns, t1_ns]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = _idle_by_span(gaps, spans)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(kernels=[(n, d) for n, _, d in events], lost_launches=lost, busy_s=busy / 1e9,
                window_s=(t1_ns - t0_ns) / 1e9, device_ops=top(by_name), idle_gaps=top(idle))


def _idle_by_span(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the host span they fall in (spans do not overlap)."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out: Dict[str, float] = {}
    for a, b in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][1] < b:
            name, s, e = spans[i]
            o = min(b, e) - max(a, s)
            if o > 0:
                out[name] = out.get(name, 0.0) + o / 1e9
                covered += o
            i += 1
        out[LOOP] = out.get(LOOP, 0.0) + (b - a - covered) / 1e9
    return out
