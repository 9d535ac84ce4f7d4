"""The load generator's client: one streamed ``/generate`` request.

Each request is clocked by the client: when it was due under the
schedule, when it was sent, and when each line of tokens arrived. A
request's time to first token is counted from when it was due, so a
client that sends late, or a replica that stalls, shows in it.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Record:
    idx: int
    prompt: List[int]
    max_new: int
    due: float                      # wall clock (time.time())
    counted: bool = True            # due inside the measured window
    sent: Optional[float] = None
    arrivals: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)       # (wall time, tokens in the line)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: Optional[Dict[str, Any]] = None   # the server's done line
    error: Optional[str] = None
    cancelled: bool = False
    _conn: Any = dataclasses.field(default=None, repr=False)
    _lock: Any = dataclasses.field(default_factory=threading.Lock,
                                   repr=False)

    @property
    def finished(self) -> bool:
        return self.done is not None and self.error is None

    @property
    def ended(self) -> bool:
        return self.done is not None or self.error is not None \
            or self.cancelled

    def ttft(self) -> Optional[float]:
        return self.arrivals[0][0] - self.due if self.arrivals else None

    def gaps(self) -> List[float]:
        """The gap before each streamed token after the first: a line's
        first token waited since the previous line, the others none."""
        out = []
        for (t0, _), (t1, n) in zip(self.arrivals, self.arrivals[1:]):
            out.append(t1 - t0)
            out.extend([0.0] * (n - 1))
        if self.arrivals:
            out.extend([0.0] * (self.arrivals[0][1] - 1))
        return out

    def cancel(self) -> None:
        """Close the connection (the replica frees the slot when its next
        write fails)."""
        with self._lock:
            self.cancelled = not self.ended
            conn = self._conn
        if conn is not None and conn.sock is not None:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def stream(port: int, rec: Record, timeout_s: float = 300.0) -> None:
    """Send ``rec`` greedy and streamed, and read its lines to the end."""
    body = json.dumps({'tokens': rec.prompt, 'max_new_tokens': rec.max_new,
                       'temperature': 0.0, 'stream': True})
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout_s)
    with rec._lock:
        if rec.cancelled:
            return
        rec._conn = conn
    try:
        rec.sent = time.time()
        conn.request('POST', '/generate', body,
                     {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            rec.error = f'HTTP {resp.status}: {resp.read()[:200]!r}'
            return
        while True:
            line = resp.readline()
            if not line:
                break
            now = time.time()
            obj = json.loads(line)
            if 'error' in obj:
                rec.error = str(obj['error'])
                return
            if obj.get('tokens'):
                rec.arrivals.append((now, len(obj['tokens'])))
                rec.tokens.extend(int(t) for t in obj['tokens'])
            if obj.get('done'):
                rec.done = obj
                return
        if rec.done is None and not rec.cancelled:
            rec.error = 'stream ended without a done line'
    except (OSError, http.client.HTTPException, ValueError) as e:
        if not rec.cancelled:
            rec.error = f'{type(e).__name__}: {e}'
    finally:
        conn.close()


def percentile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between the
    closest ranks (numpy's default), over all of them."""
    vals = sorted(values)
    if not vals:
        raise ValueError('no values')
    pos = q * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)
