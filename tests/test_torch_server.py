"""The port's replica server on the CPU (tiny model, random weights from a
seed), in-process on a free port.

``/health`` turns ok after warm-up; ``/generate`` answers with the same
JSON keys as the JAX server (read from the reference's source, so a
change there shows up here), plain and streamed, and its tokens equal
``engine.generate`` on an engine with the same weights; ``/metrics``
answers with the kernels' launch counts. A second server, started from
the command line's ``--kv-dtype int8 --spec-k 4``, takes the ``spec``
body key, answers ``accepted_len_mean``, and shows the KV dtype, the page
bytes and the speculation counters in ``/metrics``. ``--tokenizer``,
``--quantize`` and ``--checkpoint`` parse, so does the quantized
single-chip variant of ``examples/serve_llm.yaml``, and a ``--quantize``
replica built as ``main`` builds it serves the tokens of an engine on
the same int8 weights.
"""
import ast
import json
import pathlib
import time
import urllib.error
import urllib.request

import pytest

from skypilot_tpu_torch.infer import server as tserver

REF_SERVER = (pathlib.Path(__file__).resolve().parents[1]
              / 'skypilot_tpu' / 'infer' / 'server.py')


def _reference_keys():
    """String keys of the dict literals the JAX server's
    ``_answer_generate`` writes: the plain answer, the stream's token
    lines and its done line."""
    tree = ast.parse(REF_SERVER.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.AsyncFunctionDef)
              and n.name == '_answer_generate')
    dicts = [{k.value for k in d.keys if isinstance(k, ast.Constant)}
             for d in ast.walk(fn) if isinstance(d, ast.Dict)]
    answer = next(d for d in dicts if {'request_id', 'tokens'} <= d)
    done = next(d for d in dicts if 'done' in d)
    line = next(d for d in dicts if d == {'tokens', 'text'})
    return answer, done, line


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type':
                                          'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _engine():
    return tserver.build_engine('tiny', 2, 128, 16, None, 'cpu', seed=0,
                                paged=True)


def _serve(engine):
    srv = tserver.InferenceServer(engine)
    assert srv.health() == (503, {'status': 'warming'})
    port = srv.start('127.0.0.1', 0)
    base = f'http://127.0.0.1:{port}'
    deadline = time.time() + 60
    while _get(base + '/health')[0] != 200:
        assert time.time() < deadline, 'server never turned healthy'
        time.sleep(0.05)
    return srv, base


@pytest.fixture(scope='module')
def served():
    srv, base = _serve(_engine())
    yield base
    srv.shutdown()


@pytest.fixture(scope='module')
def served_int8_spec():
    args = tserver.parse_args(
        ['--port', '0', '--model', 'tiny', '--slots', '2', '--max-seq-len',
         '128', '--page-size', '16', '--device', 'cpu', '--paged',
         '--kv-dtype', 'int8', '--spec-k', '4'])
    engine = tserver.engine_from_args(args)
    # Random weights rarely repeat themselves, so the prompt-lookup
    # drafter would seldom propose: a test-side drafter that always
    # proposes the last token again makes every greedy step draft.
    engine._drafter = RepeatDrafter()
    srv, base = _serve(engine)
    yield base
    srv.shutdown()


class RepeatDrafter:
    def propose(self, context, k, memo=None):
        return [context[-1]] * k


def test_health_turns_ok(served):
    assert _get(served + '/health') == (200, {'status': 'ok'})


def test_generate_keys_and_tokens_match(served):
    answer_keys, done_keys, line_keys = _reference_keys()
    prompts = [[5, 6, 7, 8], list(range(20, 57))]
    expect = [r.output_tokens
              for r in _engine().generate(prompts, max_new_tokens=9)]
    for prompt, want in zip(prompts, expect):
        status, raw = _post(served + '/generate',
                            {'tokens': prompt, 'max_new_tokens': 9})
        body = json.loads(raw)
        assert status == 200
        assert set(body) == answer_keys
        assert body['tokens'] == want
        assert body['finish_reason'] == 'max_tokens'
        status, raw = _post(served + '/generate',
                            {'tokens': prompt, 'max_new_tokens': 9,
                             'stream': True})
        lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
        assert status == 200
        assert set(lines[-1]) == done_keys and lines[-1]['done'] is True
        assert all(set(ln) == line_keys for ln in lines[:-1])
        assert [t for ln in lines[:-1] for t in ln['tokens']] == want


def test_prompt_text_and_bad_requests(served):
    status, raw = _post(served + '/generate',
                        {'prompt': 'hi', 'max_new_tokens': 3})
    assert status == 200 and len(json.loads(raw)['tokens']) == 3
    assert _post(served + '/generate', {'max_new_tokens': 3})[0] == 400
    assert _post(served + '/generate', {'tokens': [1] * 500})[0] == 400
    assert _get(served + '/nope')[0] == 404


def test_metrics_answers(served):
    status, m = _get(served + '/metrics')
    assert status == 200
    assert m['decode_tokens'] > 0 and m['ttft_p50_s'] is not None
    assert set(m['kernel_launches']) == {
        'paged_decode_attention', 'paged_prefill_attention',
        'paged_verify_attention', 'paged_decode_attention_int8',
        'paged_prefill_attention_int8', 'paged_verify_attention_int8',
        'qdot_int8'}
    assert m['paged'] is True and m['pipeline_depth'] == 1


def test_spec_body_key_and_accepted_len_mean(served_int8_spec):
    """The speculating request drafts and rides verify steps
    (accepted_len_mean >= 1.0); the opted-out one never does (None); the
    tokens are the same."""
    base = served_int8_spec
    prompt = [11] * 40
    answers = {}
    for spec in (True, False):
        status, raw = _post(base + '/generate',
                            {'tokens': prompt, 'max_new_tokens': 10,
                             'spec': spec})
        assert status == 200
        answers[spec] = json.loads(raw)
    assert answers[True]['tokens'] == answers[False]['tokens']
    assert answers[True]['accepted_len_mean'] >= 1.0
    assert answers[False]['accepted_len_mean'] is None
    status, raw = _post(base + '/generate',
                        {'tokens': prompt, 'max_new_tokens': 10,
                         'stream': True})
    lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
    assert [t for ln in lines[:-1] for t in ln['tokens']] == \
        answers[True]['tokens']
    assert lines[-1]['accepted_len_mean'] >= 1.0


def test_int8_spec_metrics(served_int8_spec):
    _post(served_int8_spec + '/generate', {'tokens': [23] * 30,
                                           'max_new_tokens': 6})
    status, m = _get(served_int8_spec + '/metrics')
    assert status == 200
    assert m['kv_dtype'] == 'int8' and m['spec_k'] == 4
    hd = 16   # the tiny model's head_dim: int8 values plus an fp32 scale
    assert m['kv_page_bytes'] == 2 * 2 * 2 * 16 * (hd + 4)
    for key in ('spec_steps', 'spec_slot_steps', 'spec_drafted_tokens',
                'spec_accepted_tokens', 'spec_emitted_tokens',
                'spec_accept_rate', 'accepted_len_mean'):
        assert key in m, key
    assert m['spec_steps'] >= 1


# ---------- the prefix cache's routes: /kv/export and the donor pull ------
PREFIX = [(i * 7 + 3) % 250 for i in range(40)]   # 2 full pages + a tail


def _kv_server(role, **kw):
    args = tserver.parse_args(
        ['--port', '0', '--model', 'tiny', '--slots', '3', '--max-seq-len',
         '128', '--page-size', '16', '--n-pages', '13', '--device', 'cpu',
         '--paged', '--kv-dtype', 'int8', '--prefix-cache', '--role', role,
         '--kv-pull-timeout-s', '5'])
    srv = tserver.InferenceServer(
        tserver.engine_from_args(args), role=args.role,
        kv_pull_timeout_s=kw.get('timeout', args.kv_pull_timeout_s),
        kv_export_max_pages=args.kv_export_max_pages)
    port = srv.start('127.0.0.1', 0)
    base = f'http://127.0.0.1:{port}'
    deadline = time.time() + 60
    while _get(base + '/health')[0] != 200:
        assert time.time() < deadline, 'server never turned healthy'
        time.sleep(0.05)
    return srv, base


def _post_hdr(url, body, headers):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json',
                                          **headers})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


class _StubDonor:
    """A donor whose /kv/export answers ``blob`` after ``delay`` s (or
    ``status`` with no body)."""

    def __init__(self, blob=b'', delay=0.0, status=200):
        import http.server
        import threading
        stub = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 -- http.server API
                self.rfile.read(int(self.headers.get('Content-Length')
                                    or 0))
                stub.calls += 1
                time.sleep(delay)
                try:
                    self.send_response(status)
                    self.send_header('Content-Length', str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *a):
                pass

        self.calls = 0
        self.httpd = http.server.ThreadingHTTPServer(('127.0.0.1', 0), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f'http://127.0.0.1:{self.httpd.server_address[1]}'

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope='module')
def kv_pair():
    donor = _kv_server('prefill')
    puller = _kv_server('decode', timeout=1.0)
    yield donor, puller
    donor[0].shutdown()
    puller[0].shutdown()


def test_kv_export_answers_200_404_409_400(kv_pair, served):
    (dsrv, donor), _ = kv_pair
    status, raw = _post(donor + '/kv/export', {'tokens': PREFIX})
    assert status == 404 and json.loads(raw)['error'] == 'no cached prefix'
    status, raw = _post(donor + '/generate', {'tokens': PREFIX,
                                              'max_new_tokens': 4})
    assert status == 200
    status, blob = _post(donor + '/kv/export', {'tokens': PREFIX})
    assert status == 200
    assert blob == dsrv.engine._kv_export(PREFIX)
    from skypilot_tpu_torch.infer import kv_wire
    assert kv_wire.unpack(blob).tokens == PREFIX[:32]
    # The page cap: the prompt is cut to 2 pages of tokens, whose cached
    # prefix stops a page short of the cut (a match never covers the last
    # token).
    dsrv.kv_export_max_pages = 2
    try:
        status, one = _post(donor + '/kv/export', {'tokens': PREFIX})
    finally:
        dsrv.kv_export_max_pages = 64
    assert status == 200 and kv_wire.unpack(one).n_pages == 1
    assert _post(donor + '/kv/export', {'nope': 1})[0] == 400
    status, raw = _post(served + '/kv/export', {'tokens': PREFIX})
    assert status == 409


def test_metrics_carry_role_and_the_prefix_index(kv_pair, served):
    (_, donor), (_, puller) = kv_pair
    _post(donor + '/generate', {'tokens': PREFIX, 'max_new_tokens': 4})
    status, m = _get(donor + '/metrics')
    assert status == 200 and m['role'] == 'prefill'
    snap = m['kv_prefix_index']
    assert snap['page'] == 16 and len(snap['full']) >= 2
    status, m2 = _get(donor + f'/metrics?prefix_gen={snap["gen"]}')
    assert m2['kv_prefix_index'] == {'gen': snap['gen'], 'crc': snap['crc'],
                                     'page': 16, 'delta': []}
    assert _get(puller + '/metrics')[1]['role'] == 'decode'
    status, m = _get(served + '/metrics')
    assert m['role'] == 'mixed' and 'kv_prefix_index' not in m
    with pytest.raises(ValueError):
        tserver.InferenceServer(_engine(), role='router')
    with pytest.raises(SystemExit):
        tserver.parse_args(['--port', '0', '--role', 'router'])


def test_donor_pull_transfers_and_degrades_to_recompute(kv_pair):
    """A clean pull grafts the donor's pages (the answer is the donor's
    own); a corrupt blob and a donor stalled past the budget are counted
    failures and the request recomputes to the same tokens; a donor 404
    is a clean miss, not a failure."""
    (dsrv, donor), (psrv, puller) = kv_pair
    prompts = [PREFIX + [101, 55, 3, 9], [33] * 16 + [7] * 30 + [1, 2],
               [60 + i for i in range(40)] + [5], [77] * 37]
    want = []
    for p in prompts:
        status, raw = _post(donor + '/generate', {'tokens': p,
                                                  'max_new_tokens': 6})
        want.append(json.loads(raw)['tokens'])
    hdr = {tserver.KV_DONOR_HEADER: donor}

    def metrics():
        return _get(puller + '/metrics')[1]

    m0 = metrics()
    got = _post_hdr(puller + '/generate', {'tokens': prompts[0],
                                           'max_new_tokens': 6}, hdr)
    m1 = metrics()
    assert got['tokens'] == want[0] and got['cached_tokens'] == 32
    assert m1['kv_transfers_total'] == m0['kv_transfers_total'] + 1
    assert m1['kv_transfer_bytes'] > m0['kv_transfer_bytes']
    assert m1['kv_transfer_failures'] == m0['kv_transfer_failures']
    assert m1['kv_transfer_p99_s'] > 0

    blob = dsrv.engine._kv_export(prompts[1])
    bad = _StubDonor(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    slow = _StubDonor(blob, delay=3.0)
    miss = _StubDonor(status=404)
    try:
        for i, stub, failed in ((1, bad, 1), (2, slow, 1), (3, miss, 0)):
            before = metrics()
            got = _post_hdr(puller + '/generate',
                            {'tokens': prompts[i], 'max_new_tokens': 6},
                            {tserver.KV_DONOR_HEADER: stub.url})
            after = metrics()
            assert stub.calls == 1
            assert got['tokens'] == want[i], i
            assert got['cached_tokens'] == 0, i
            assert (after['kv_transfer_failures']
                    - before['kv_transfer_failures']) == failed, i
            assert after['kv_transfers_total'] == before[
                'kv_transfers_total'], i
    finally:
        for stub in (bad, slow, miss):
            stub.close()
    assert _get(puller + '/health')[0] == 200


def _yaml_run_args():
    """The replica's flags in examples/serve_llm.yaml's run command."""
    path = REF_SERVER.parents[2] / 'examples' / 'serve_llm.yaml'
    run = path.read_text().split('run: |', 1)[1].split('service:', 1)[0]
    words = run.replace('\\', ' ').split()
    return words[words.index('skypilot_tpu.infer.server') + 1:]


def test_tokenizer_quantize_checkpoint_flags_parse():
    args = tserver.parse_args(['--port', '0'])
    assert (args.tokenizer, args.quantize, args.checkpoint) == \
        (None, False, None)
    args = tserver.parse_args(['--port', '0', '--tokenizer', 't.json',
                               '--quantize', '--checkpoint', '/ck'])
    assert (args.tokenizer, args.quantize, args.checkpoint) == \
        ('t.json', True, '/ck')
    # The example's quantized single-chip variant: its run line with
    # --quantize in place of --tp 8 (tensor parallelism is not ported).
    words = _yaml_run_args()
    i = words.index('--tp')
    variant = words[:i] + words[i + 2:] + ['--quantize']
    variant[variant.index('$SKYPILOT_SERVE_PORT')] = '8000'
    args = tserver.parse_args(variant)
    assert (args.model, args.quantize, args.slots, args.max_seq_len,
            args.tokenizer) == ('8b', True, 16, 2048,
                                'examples/tokenizer_8k.json')
    # The replica is dense unless --paged, as the reference's is.
    assert [tserver.engine_from_args(tserver.parse_args(
        ['--port', '0', '--model', 'tiny', '--device', 'cpu',
         '--max-seq-len', '128', '--page-size', '16'] + flags)).metrics()[
        'paged'] for flags in ([], ['--paged'])] == [False, True]


def test_quantized_replica_serves_the_int8_engines_tokens(monkeypatch):
    """server_from_args with --quantize draws random int8 weights (the
    reference's log line) and serves an engine's tokens on them; a
    tokenizer over the model's vocabulary exits before any weight."""
    args = tserver.parse_args(
        ['--port', '0', '--model', 'tiny', '--slots', '2', '--max-seq-len',
         '128', '--page-size', '16', '--device', 'cpu', '--paged',
         '--quantize'])
    srv = tserver.server_from_args(args)
    assert tserver.quant_lib.is_quantized(srv.engine.params)
    port = srv.start('127.0.0.1', 0)
    base = f'http://127.0.0.1:{port}'
    try:
        deadline = time.time() + 60
        while _get(base + '/health')[0] != 200:
            assert time.time() < deadline
            time.sleep(0.05)
        prompt = list(range(20, 57))
        want = tserver.build_engine('tiny', 2, 128, 16, None, 'cpu',
                                    paged=True, quantize=True).generate(
                                        [prompt], max_new_tokens=9)
        status, raw = _post(base + '/generate',
                            {'tokens': prompt, 'max_new_tokens': 9})
        assert status == 200
        assert json.loads(raw)['tokens'] == want[0].output_tokens
        assert 'qdot_int8' in _get(base + '/metrics')[1]['kernel_launches']
    finally:
        srv.shutdown()
    path = REF_SERVER.parents[2] / 'examples' / 'tokenizer_8k.json'
    monkeypatch.setattr(tserver, 'load_params', None)   # never reached
    with pytest.raises(SystemExit, match='exceeds the model vocab'):
        tserver.server_from_args(tserver.parse_args(
            ['--port', '0', '--model', 'tiny', '--device', 'cpu',
             '--tokenizer', str(path)]))


def test_compile_cache_dir_moves_the_kernel_build_directory(
        tmp_path, monkeypatch, caplog):
    """``--compile-cache-dir`` points the kernel build directory at its
    argument (``/metrics`` says where, and the seconds each compile took:
    none on the CPU). A directory that cannot be made, or one asked for
    after a kernel library was loaded, only warns: the directory stays
    where it was and the replica serves."""
    from skypilot_tpu_torch.ops import _build
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    default = _build.BUILD_DIR
    (tmp_path / 'file').write_text('not a directory')
    bad = str(tmp_path / 'file' / 'kernels')
    args = tserver.parse_args(
        ['--port', '0', '--model', 'tiny', '--slots', '2', '--max-seq-len',
         '128', '--device', 'cpu', '--compile-cache-dir', bad])
    assert args.compile_cache_dir == bad
    with caplog.at_level('WARNING', logger=tserver.logger.name):
        assert tserver.setup_compile_cache(args.compile_cache_dir) is False
    assert 'compile cache setup failed' in caplog.text
    assert _build.BUILD_DIR == default
    srv = tserver.server_from_args(args)
    base = f'http://127.0.0.1:{srv.start("127.0.0.1", 0)}'
    try:
        deadline = time.time() + 60
        while _get(base + '/health')[0] != 200:
            assert time.time() < deadline
            time.sleep(0.05)
        status, raw = _post(base + '/generate',
                            {'tokens': [5, 6, 7], 'max_new_tokens': 4})
        assert status == 200 and len(json.loads(raw)['tokens']) == 4
        m = _get(base + '/metrics')[1]
        assert m['kernel_build_dir'] == str(default)
        assert m['kernel_build_s'] == {}
    finally:
        srv.shutdown()
    good = tmp_path / 'kernels'
    assert tserver.setup_compile_cache(str(good)) is True
    assert _build.BUILD_DIR == good and good.is_dir()
    # Once a library is loaded the directory stays.
    monkeypatch.setitem(_build._libs, 'paged_decode', object())
    caplog.clear()
    with caplog.at_level('WARNING', logger=tserver.logger.name):
        assert tserver.setup_compile_cache(str(tmp_path / 'other')) is False
    assert 'already loaded' in caplog.text
    assert _build.BUILD_DIR == good
    assert tserver.replica_sources(args) == ('paged_decode', 'paged_prefill')
    args.quantize = True
    assert tserver.replica_sources(args)[-1] == 'qdot_int8'


def test_warm_up_builds_the_replica_kernels_first(monkeypatch):
    """The replica's kernel sources are built at the start of its warm-up,
    before any step program is captured, so that a cold boot's compile
    counts in ``coldstart.compiled``'s ``warm_s`` (on the CPU
    ``server_from_args`` passes none: the wrappers run their plain
    versions)."""
    from skypilot_tpu_torch.ops import _build
    order, stamps = [], {}

    def build(names):
        order.append(tuple(names))
        time.sleep(0.3)
        return {n: 0.3 for n in names}
    monkeypatch.setattr(_build, 'build', build)
    engine = _engine()
    monkeypatch.setattr(engine, 'note_lifecycle_event',
                        lambda event, **kw: stamps.setdefault(event, kw))

    def finish(warm):
        while not all(w.done for w in warm):
            engine.step()
    srv = tserver.InferenceServer(engine,
                                  kernel_sources=('paged_decode', 'x'))
    assert srv._warm_up(lambda: order.append('capture'), engine.submit,
                        finish)
    assert order == [('paged_decode', 'x'), 'capture']
    assert stamps['coldstart.compiled']['warm_s'] >= 0.3
    args = tserver.parse_args(['--port', '0', '--model', 'tiny',
                               '--device', 'cpu'])
    assert tserver.server_from_args(args).kernel_sources == ()
