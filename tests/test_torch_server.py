"""The port's replica server on the CPU (tiny model, random weights from a
seed), in-process on a free port.

``/health`` turns ok after warm-up; ``/generate`` answers with the same
JSON keys as the JAX server (read from the reference's source, so a
change there shows up here), plain and streamed, and its tokens equal
``engine.generate`` on an engine with the same weights; ``/metrics``
answers with the kernels' launch counts. A second server, started from
the command line's ``--kv-dtype int8 --spec-k 4``, takes the ``spec``
body key, answers ``accepted_len_mean``, and shows the KV dtype, the page
bytes and the speculation counters in ``/metrics``.
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
    return tserver.build_engine('tiny', 2, 128, 16, None, 'cpu', seed=0)


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
         '128', '--page-size', '16', '--device', 'cpu', '--kv-dtype', 'int8',
         '--spec-k', '4'])
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
        'paged_prefill_attention_int8', 'paged_verify_attention_int8'}
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
