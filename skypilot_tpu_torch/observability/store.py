"""Span store: sqlite persistence for the flight recorder's anomaly
dumps (a copy of ``SpanStore`` and ``sanitize_label`` from
``skypilot_tpu/observability/store.py``).

The same table, indexes and default file (``traces.db`` under
``$SKY_TPU_HOME``, default ``~/.sky_tpu``) as the reference, so the
control plane's ``sky-tpu profile`` and ``sky-tpu trace`` read a torch
replica's dumps unchanged. The reference's postgres backend and its
ingest path (which feeds the API server's metrics) stay with the
control plane.
"""
from __future__ import annotations

import json
import os
import re
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

HOME_ENV_VAR = 'SKY_TPU_HOME'

_local = threading.local()


def base_dir() -> str:
    """The framework's state root (``~/.sky_tpu``, or $SKY_TPU_HOME)."""
    d = os.path.expanduser(os.environ.get(HOME_ENV_VAR, '~/.sky_tpu'))
    os.makedirs(d, exist_ok=True)
    return d


# Whole-trace GC cap (rows). Oldest traces are dropped first; a trace is
# never half-deleted (a broken parent chain renders as orphans).
MAX_SPANS_ENV = 'SKY_TPU_TRACE_MAX_SPANS'
DEFAULT_MAX_SPANS = 100_000
# Age-based retention: whole traces whose NEWEST span is older than
# this many seconds are dropped at GC time, regardless of the row
# count — a long-lived replica under the size cap must not keep
# week-old flight-recorder rings around. 0/unset disables the TTL;
# both caps compose (age first, then size).
TTL_ENV = 'SKY_TPU_TRACE_TTL_S'

_SCHEMA = """
CREATE TABLE IF NOT EXISTS spans (
    trace_id TEXT,
    span_id TEXT,
    parent_id TEXT,
    name TEXT,
    hop TEXT,
    start_ts REAL,
    dur_s REAL,
    status TEXT,
    attrs_json TEXT,
    request_id TEXT
);
CREATE INDEX IF NOT EXISTS idx_spans_trace ON spans (trace_id);
CREATE INDEX IF NOT EXISTS idx_spans_request ON spans (request_id);
CREATE INDEX IF NOT EXISTS idx_spans_start ON spans (start_ts);
"""


class SpanStore:
    def __init__(self, db_path: Optional[str] = None):
        self.db_path = db_path or os.path.join(base_dir(), 'traces.db')

    @property
    def _conn(self) -> sqlite3.Connection:
        # One connection per thread and file (sqlite connections are
        # not shared across threads), the schema applied on first use.
        conns = _local.__dict__.setdefault('conns', {})
        conn = conns.get(self.db_path)
        if conn is None:
            os.makedirs(os.path.dirname(self.db_path) or '.', exist_ok=True)
            conn = sqlite3.connect(self.db_path, timeout=30.0)
            conn.row_factory = sqlite3.Row
            conn.executescript(_SCHEMA)
            conns[self.db_path] = conn
        return conn

    def add_spans(self, spans: List[Dict[str, Any]]) -> int:
        rows = []
        for s in spans:
            attrs = s.get('attrs') or {}
            if not isinstance(attrs, dict):
                attrs = {}
            attrs_json = json.dumps(attrs, default=str)
            # Attr payloads are caller-controlled (and the collector
            # endpoint is unauthenticated): bound bytes per span so the
            # store's GC row cap is also, in effect, a byte cap.
            if len(attrs_json) > 8192:
                attrs_json = json.dumps(
                    {'_truncated': True,
                     'request_id': attrs.get('request_id')})
            rows.append((
                str(s['trace_id'])[:64], str(s['span_id'])[:64],
                (str(s['parent_id'])[:64]
                 if s.get('parent_id') is not None else None),
                str(s.get('name', ''))[:256], str(s.get('hop', ''))[:64],
                float(s.get('start', 0.0)), float(s.get('dur_s', 0.0)),
                str(s.get('status', 'ok'))[:128], attrs_json,
                (str(attrs['request_id'])[:64]
                 if attrs.get('request_id') is not None else None),
            ))
        if not rows:
            return 0
        self._conn.executemany(
            'INSERT INTO spans (trace_id, span_id, parent_id, name, hop,'
            ' start_ts, dur_s, status, attrs_json, request_id) '
            'VALUES (?,?,?,?,?,?,?,?,?,?)', rows)
        self._conn.commit()
        return len(rows)

    @staticmethod
    def _row_to_span(row) -> Dict[str, Any]:
        d = dict(row)
        d['attrs'] = json.loads(d.pop('attrs_json') or '{}')
        d['start'] = d.pop('start_ts')
        return d

    def get_trace(self, trace_id: str) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            'SELECT * FROM spans WHERE trace_id=? ORDER BY start_ts',
            (trace_id,)).fetchall()
        return [self._row_to_span(r) for r in rows]

    def trace_id_for_request(self, request_id: str) -> Optional[str]:
        row = self._conn.execute(
            'SELECT trace_id FROM spans WHERE request_id=? '
            'ORDER BY start_ts LIMIT 1', (request_id,)).fetchone()
        return row['trace_id'] if row else None

    def trace_for_request(self, request_id: str) -> List[Dict[str, Any]]:
        trace_id = self.trace_id_for_request(request_id)
        if trace_id is None:
            return []
        return self.get_trace(trace_id)

    def trace_ids_for_request(self, request_id: str) -> List[str]:
        """Every trace containing the request, newest first. A request
        can appear in both its ordinary propagated-span trace and one
        or more flight-recorder dumps (``stepline-*``); callers that
        want a specific kind filter on the trace-id prefix."""
        rows = self._conn.execute(
            'SELECT trace_id, MAX(start_ts) AS newest FROM spans '
            'WHERE request_id=? GROUP BY trace_id '
            'ORDER BY newest DESC', (request_id,)).fetchall()
        return [r['trace_id'] for r in rows]

    def list_traces(self, limit: int = 50,
                    trace_id_prefix: Optional[str] = None,
                    ) -> List[Dict[str, Any]]:
        """Most-recent-first trace summaries (for `sky-tpu trace` with
        no argument / the API listing). ``trace_id_prefix`` filters
        SERVER-side (``stepline-`` for flight-recorder dumps) — a
        post-filtered page would lose dumps behind ``limit`` newer
        ordinary traces on a busy store."""
        where = ''
        args: tuple = ()
        if trace_id_prefix:
            esc = (trace_id_prefix.replace('\\', '\\\\')
                   .replace('%', '\\%').replace('_', '\\_'))
            where = "WHERE trace_id LIKE ? ESCAPE '\\' "
            args = (esc + '%',)
        rows = self._conn.execute(
            'SELECT trace_id, MIN(start_ts) AS start_ts,'
            ' COUNT(*) AS n_spans, MAX(request_id) AS request_id '
            'FROM spans ' + where + 'GROUP BY trace_id '
            'ORDER BY start_ts DESC LIMIT ?',
            args + (limit,)).fetchall()
        out = []
        for r in rows:
            d = dict(r)
            root = self._conn.execute(
                'SELECT name FROM spans WHERE trace_id=? AND '
                'parent_id IS NULL ORDER BY start_ts LIMIT 1',
                (d['trace_id'],)).fetchone()
            d['root'] = root['name'] if root else None
            out.append(d)
        return out

    def count(self) -> int:
        return self._conn.execute(
            'SELECT COUNT(*) AS n FROM spans').fetchone()['n']

    def gc(self, max_spans: Optional[int] = None,
           ttl_s: Optional[float] = None) -> int:
        """Drop whole traces past the age TTL (``SKY_TPU_TRACE_TTL_S``;
        a trace's age is its NEWEST span), then oldest whole traces
        until the row count fits the size cap. The two caps compose:
        age first — so the size pass only ever sees live-window traces
        — then size. Returns total rows deleted.

        Set-based: one aggregate scan picks the victim traces, one
        DELETE drops them — a per-trace loop would re-COUNT the full
        table thousands of times when small SDK traces pushed it over
        cap."""
        if max_spans is None:
            max_spans = int(os.environ.get(MAX_SPANS_ENV,
                                           DEFAULT_MAX_SPANS))
        if ttl_s is None:
            try:
                ttl_s = float(os.environ.get(TTL_ENV, '0') or 0)
            except ValueError:
                ttl_s = 0.0
        deleted = 0
        if ttl_s and ttl_s > 0:
            cutoff = time.time() - ttl_s
            # Single statement with ONE bound variable: a populated
            # store's first TTL pass can expire tens of thousands of
            # small traces, and an IN (?,?,...) victim list would
            # blow sqlite's bound-variable limit and fail ingest.
            cur = self._conn.execute(
                'DELETE FROM spans WHERE trace_id IN ('
                'SELECT trace_id FROM spans GROUP BY trace_id '
                'HAVING MAX(start_ts) < ?)', (cutoff,))
            self._conn.commit()
            deleted += cur.rowcount
        excess = self.count() - max_spans
        if excess <= 0:
            return deleted
        rows = self._conn.execute(
            'SELECT trace_id, COUNT(*) AS n FROM spans '
            'GROUP BY trace_id ORDER BY MIN(start_ts)').fetchall()
        victims = []
        for r in rows:
            if excess <= 0:
                break
            victims.append(r['trace_id'])
            excess -= r['n']
        if not victims:
            return deleted
        marks = ','.join('?' for _ in victims)
        cur = self._conn.execute(
            f'DELETE FROM spans WHERE trace_id IN ({marks})',
            tuple(victims))
        self._conn.commit()
        return deleted + cur.rowcount


# Label values fed to Prometheus are client-controlled (tenant ids):
# they must not be able to corrupt the exposition format (quotes,
# newlines) or carry unbounded payloads. The reference's rule.
_LABEL_RE = re.compile(r'[^A-Za-z0-9_.:/\-]')


def sanitize_label(value: Any) -> str:
    return _LABEL_RE.sub('_', str(value))[:64]
