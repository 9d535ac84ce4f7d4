"""The tail and rate arithmetic, over every request, against a stub
replica; a deliberate stall shows in the due-time clock."""
from __future__ import annotations

import http.server
import json
import threading
import time
import types

import pytest

from perfbench import client as client_lib
from perfbench import spec
from perfbench.traffic import open as open_lib


class _Stub(http.server.BaseHTTPRequestHandler):
    """Streams max_new_tokens tokens, one line each ``gap`` s apart; while
    the server's ``stall_until`` lies ahead, a request waits for it."""
    protocol_version = 'HTTP/1.0'

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers['Content-Length'])))
        srv = self.server
        wait = srv.stall_until - time.time()
        if wait > 0:
            time.sleep(wait)
        self.send_response(200)
        self.end_headers()
        for _ in range(body['max_new_tokens']):
            self.wfile.write(json.dumps({'tokens': [1], 'text': ''}).encode()
                             + b'\n')
            self.wfile.flush()
            time.sleep(srv.gap)
        self.wfile.write(json.dumps({'done': True, 'queue_wait_s': 0.0,
                                     'ttft_s': 0.0}).encode() + b'\n')


@pytest.fixture
def stub():
    srv = http.server.ThreadingHTTPServer(('127.0.0.1', 0), _Stub)
    srv.daemon_threads = True
    srv.stall_until = 0.0
    srv.gap = 0.01
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_percentile_is_linear_over_all_values():
    vals = list(range(1, 101))
    assert client_lib.percentile(vals, 0.9) == pytest.approx(90.1)
    assert client_lib.percentile([5.0], 0.99) == 5.0
    assert client_lib.percentile([1, 2, 3, 4], 0.5) == 2.5


def test_gaps_count_tokens_in_one_line_as_no_gap():
    r = client_lib.Record(idx=0, prompt=[1], max_new=4, due=0.0)
    r.arrivals = [(1.0, 2), (1.5, 1), (1.75, 1)]
    assert sorted(r.gaps()) == [0.0, 0.25, 0.5]
    assert r.ttft() == 1.0


def _run(stub, rate, seconds, stall=None, max_new=3):
    params = {'rate_per_s': rate, 'max_total': 2048, 'order_seed': 1,
              'prompt': {'dist': 'uniform', 'min': 4, 'max': 8},
              'output': {'dist': 'uniform', 'min': max_new,
                         'max': max_new}}
    t0 = time.time() + 0.2
    if stall:
        stub.stall_until = t0 + stall
    recs = open_lib.run(stub.server_address[1], params, 3, seconds, 512, t0,
                        drain_wait_s=5.0)
    run = types.SimpleNamespace(records=recs, t0=t0, t1=t0 + seconds,
                                seconds=seconds, drain_wait_s=5.0,
                                counted=[r for r in recs if r.counted])
    return run


def test_due_time_clock_counts_a_stall(stub):
    run = _run(stub, rate=20.0, seconds=1.0, stall=0.6)
    counted = run.counted
    assert len(counted) == 20 and all(r.finished for r in counted)
    # A request due at the window's start waited out the whole stall.
    first = min(counted, key=lambda r: r.due)
    assert first.ttft() >= 0.55
    # Sends were never held back: each went out when it was due.
    assert max(r.sent - r.due for r in counted) < 0.1
    p90 = spec.reader('ttft_p90_s')(run)
    ttfts = sorted(r.ttft() for r in counted)
    assert p90 == pytest.approx(client_lib.percentile(ttfts, 0.9))
    assert p90 > 0.3


def test_unanswered_and_failed_requests_count_as_the_whole_wait(stub):
    run = _run(stub, rate=10.0, seconds=1.0)
    counted = run.counted
    counted[0].arrivals, counted[0].error = [], 'HTTP 500'
    counted[1].arrivals = []
    got = spec.reader('ttft_p90_s')(run)
    give_up = run.t1 + run.drain_wait_s
    worst = sorted([give_up - counted[0].due, give_up - counted[1].due])
    ttfts = [r.ttft() for r in counted[2:]] + worst
    assert got == pytest.approx(client_lib.percentile(ttfts, 0.9))


def test_itl_and_tokens_per_s_over_every_request(stub):
    run = _run(stub, rate=10.0, seconds=1.0, max_new=5)
    gaps = [g for r in run.counted for g in r.gaps()]
    assert len(gaps) == 4 * len(run.counted)
    assert spec.reader('itl_p99_ms')(run) == pytest.approx(
        client_lib.percentile(gaps, 0.99) * 1e3)
    inside = sum(n for r in run.records for t, n in r.arrivals
                 if run.t0 <= t < run.t1)
    assert spec.reader('output_tokens_per_s')(run) == inside / 1.0
