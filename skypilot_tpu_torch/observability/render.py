"""Chrome-trace (Perfetto) export of span-store rows (a copy of
``to_perfetto`` from ``skypilot_tpu/observability/render.py``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def to_perfetto(spans: List[Dict[str, Any]],
                extra_events: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
    """Chrome trace JSON. Each hop becomes a pid row (named via
    process_name metadata); spans become 'X' events whose ts/dur are in
    microseconds of wall time, so cross-hop spans line up on one clock.
    ``extra_events`` takes raw events already in this format (the flight
    recorder's tracks) and merges them verbatim."""
    hops = []
    events: List[Dict[str, Any]] = []
    for s in spans:
        hop = s.get('hop') or '?'
        if hop not in hops:
            hops.append(hop)
        ev = {
            'name': s.get('name', '?'),
            'ph': 'X',
            'ts': float(s.get('start') or 0.0) * 1e6,
            'dur': float(s.get('dur_s') or 0.0) * 1e6,
            'pid': hops.index(hop) + 1,
            'tid': 1,
            'args': {
                'trace_id': s.get('trace_id'),
                'span_id': s.get('span_id'),
                'parent_id': s.get('parent_id'),
                'status': s.get('status'),
                **(s.get('attrs') or {}),
            },
        }
        events.append(ev)
    meta = [
        {'name': 'process_name', 'ph': 'M', 'pid': i + 1, 'tid': 1,
         'args': {'name': hop}} for i, hop in enumerate(hops)
    ]
    if extra_events:
        events.extend(extra_events)
    return {'traceEvents': meta + events, 'displayTimeUnit': 'ms'}
