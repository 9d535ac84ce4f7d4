"""Reduce a ``torch.profiler`` trace to what the metrics read.

The device's busy time is the union of the intervals in which any device
operation (kernel, copy, set) ran, clipped to the profiled span: kernels
that overlap count once. Kernel time by name is the sum of each kernel's
own durations. Idle gaps are the holes in that union.

The profiler's timestamps are wall-clock nanoseconds; a marker recorded
at a known ``time.time()`` right after the profiler starts pins the
offset between the two clocks (tens of microseconds on the card), so
gaps can be set against the host's own records (the engine's step
records).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

MARK = 'perfbench.clock_mark'
# Kernel families by a part of the kernel's name.
FAMILIES = {
    'paged_prefill': 'paged_prefill_kernel',
    'paged_decode': 'paged_attention_kernel',
    'flash_fwd': 'flash_fwd_kernel',
    'flash_bwd_dq': 'flash_bwd_dq_kernel',
    'flash_bwd_dkv': 'flash_bwd_dkv_kernel',
    'qdot_int8': 'qdot_int8_kernel',
    'ce_fwd': 'ce_fwd_kernel',
}


class Profile:
    """A running ``torch.profiler`` over the host's operations and, where
    there is a card, its CUDA activity."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if torch.cuda.is_available() else [])
        self._prof = profile(activities=acts)
        self.start_wall = self.stop_wall = 0.0
        self.mark_wall = 0.0

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof.start()
        self.start_wall = time.time()
        with record_function(MARK):
            self.mark_wall = time.time()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stop_wall = time.time()
        self._prof.stop()

    def reduce(self, top: int = 10, gaps: int = 50,
               cpu_labels: bool = False,
               seconds: Optional[float] = None) -> Dict[str, Any]:
        """The trace reduced over its whole span, or over its first
        ``seconds``."""
        stop = (self.stop_wall if seconds is None
                else min(self.stop_wall, self.start_wall + seconds))
        return reduce(self._prof.profiler.kineto_results.events(),
                      self.start_wall, stop, self.mark_wall,
                      top=top, gaps=gaps, cpu_labels=cpu_labels)


def _host_op(ops: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost (latest started) host operation running at ``t``."""
    best = None
    for a, b, name in ops:
        if a <= t < b and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else 'no host operation'


def _union(intervals: List[Tuple[int, int]]
           ) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, merged intervals) of sorted ``intervals``."""
    merged: List[Tuple[int, int]] = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def reduce(events, start_wall: float, stop_wall: float, mark_wall: float,
           top: int = 10, gaps: int = 50, cpu_labels: bool = False
           ) -> Dict[str, Any]:
    """Busy seconds, span, kernel time by name and by family, the top
    device operations, and the longest idle gaps as [label, seconds,
    wall-clock start]: with ``cpu_labels`` the label is the innermost
    host operation the profiler saw running at the gap's middle, else
    'idle' (a caller with its own records names them)."""
    from torch.autograd import DeviceType
    offset_ns = 0
    device, cpu_ops = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.duration_ns(), e.name()))
        elif e.name() == MARK:
            offset_ns = int(mark_wall * 1e9) - e.start_ns()
        elif cpu_labels:
            cpu_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
    lo, hi = int(start_wall * 1e9), int(stop_wall * 1e9)
    spans, by_name = [], {}
    for start, dur, name in device:
        a, b = start + offset_ns, start + offset_ns + dur
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        tot, n = by_name.get(name, (0, 0))
        by_name[name] = (tot + (b - a), n + 1)
    spans.sort()
    busy_ns, merged = _union(spans)
    holes = []
    prev = lo
    for a, b in merged:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        holes.append((prev, hi))
    holes.sort(key=lambda h: h[0] - h[1])
    families = {}
    for fam, part in FAMILIES.items():
        hits = [(t, n) for name, (t, n) in by_name.items() if part in name]
        if hits:
            families[fam] = {'seconds': sum(t for t, _ in hits) / 1e9,
                             'launches': sum(n for _, n in hits)}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        'window_s': (hi - lo) / 1e9,
        'start_wall': start_wall, 'stop_wall': stop_wall,
        'busy_s': busy_ns / 1e9,
        'clock_offset_ns': offset_ns,
        'families': families,
        'device_ops': [[name, t / 1e9] for name, (t, _) in ranked],
        'idle_gaps': [[_host_op(cpu_ops, (a + b) // 2 - offset_ns)
                       if cpu_labels else 'idle',
                       (b - a) / 1e9, a / 1e9] for a, b in holes[:gaps]],
        'events': len(spans),
    }
