"""HTTP inference server: the replica a serving deployment runs
(counterpart of ``skypilot_tpu/infer/server.py``, with the same routes and
wire format for what this slice ports).

Endpoints:

- ``GET  /health``   -> 200 ``{"status": "ok"}`` once the engine is warm,
  503 ``{"status": "warming"}`` before (``"dead"`` if the loop died).
- ``POST /generate`` -> {"tokens": [int] | "prompt": str, optional
  "max_new_tokens", "temperature", "stream"}. The answer is one JSON
  object, or with ``"stream": true`` JSON lines: ``{"tokens", "text"}``
  per token batch and a final ``{"done": true, ...}`` line.
- ``GET  /metrics``  -> engine metrics as JSON (TTFT p50, decode tokens,
  steps, each kernel's launch count).

It uses the standard library's ``ThreadingHTTPServer``: one thread per
connection enqueues its request and waits on the request's condition,
while a background thread drives ``engine.step()`` (continuous batching
over every waiting request).

Without a checkpoint the server serves random weights sized by
``--model``, drawn from ``--seed``. Run:
``python -m skypilot_tpu_torch.infer.server --port 8000 --model 8b``
(add ``--device cpu`` to run on the CPU).
"""
from __future__ import annotations

import argparse
import http.server
import json
import logging
import threading
import time
from typing import List, Optional

import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models import llama

logger = logging.getLogger(__name__)

MODELS = {
    'tiny': llama.LlamaConfig.tiny,
    '350m': llama.LlamaConfig.bench_350m,
    '1b': llama.LlamaConfig.bench_1b,
    '8b': llama.LlamaConfig.llama3_8b,
}


class Tokenizer:
    """Byte-level text<->token codec for ``/generate`` prompts (the
    reference's fallback path; ``tokens`` callers need none)."""

    kind = 'bytes'

    def encode(self, text: str) -> List[int]:
        return list(text.encode('utf-8'))

    def decode(self, tokens: List[int]) -> str:
        try:
            return bytes(t for t in tokens if 0 <= t < 256).decode(
                'utf-8', errors='replace')
        except ValueError:
            return ''


class IncrementalDecoder:
    """Streaming detokenizer: the text of each new token batch, holding
    back a trailing replacement character that may still become a real
    multi-byte character (a copy of the reference's)."""

    _CONTEXT = 4
    _MAX_WINDOW = 64

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tok = tokenizer
        self._prefix = 0
        self._emitted = 0

    def feed(self, tokens: List[int], n: Optional[int] = None) -> str:
        if n is None:
            n = len(tokens)
        window = self._tok.decode(tokens[self._prefix:n])
        if (not window.endswith('\ufffd')
                or n - self._prefix >= self._MAX_WINDOW):
            delta = window[self._emitted:]
            self._prefix = max(0, n - self._CONTEXT)
            self._emitted = len(self._tok.decode(tokens[self._prefix:n]))
            return delta
        stable = len(window) - 1
        delta = window[self._emitted:stable]
        self._emitted = max(self._emitted, stable)
        return delta

    def flush(self, tokens: List[int], n: Optional[int] = None) -> str:
        if n is None:
            n = len(tokens)
        window = self._tok.decode(tokens[self._prefix:n])
        delta = window[self._emitted:]
        self._prefix = n
        self._emitted = 0
        return delta


class InferenceServer:
    """The engine loop thread plus the HTTP front end."""

    def __init__(self, engine: engine_lib.InferenceEngine,
                 tokenizer: Optional[Tokenizer] = None) -> None:
        self.engine = engine
        self.tokenizer = tokenizer or Tokenizer()
        # One-way flags written by the engine thread, read by handlers.
        self.ready = False
        self.dead = ''
        self._active = 0
        self._active_lock = threading.Lock()
        self._stop = threading.Event()
        self._woken = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='engine-loop')
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None

    # ---- engine loop -----------------------------------------------------
    def _loop(self) -> None:
        try:
            t0 = time.time()
            warm = self.engine.submit([1], max_new_tokens=2)
            while not warm.done:
                self.engine.step()
            logger.info('engine warm in %.1fs', time.time() - t0)
            self.ready = True
            while not self._stop.is_set():
                if self.engine.step() == 0:
                    # Idle: wait for a submit to wake us (the timeout is
                    # a safety net, not a poll cadence).
                    self._woken.wait(timeout=0.1)
                    self._woken.clear()
        except Exception as e:  # noqa: BLE001 -- a dead loop must unready
            logger.exception('engine loop died')
            self.dead = f'{type(e).__name__}: {e}'
            self.ready = False

    # ---- lifecycle -------------------------------------------------------
    def start(self, host: str, port: int) -> int:
        """Start the engine loop and the HTTP server in background
        threads; returns the bound port (``port`` 0 picks a free one)."""
        server = self

        class Handler(_Handler):
            srv = server

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self._httpd.daemon_threads = True
        self._thread.start()
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name='http').start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        self._stop.set()
        self._woken.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._thread.join(timeout=30)

    def run(self, host: str, port: int) -> None:
        self.start(host, port)
        try:
            while not self._stop.wait(1.0):
                pass
        finally:
            self.shutdown()

    # ---- routes ----------------------------------------------------------
    def health(self):
        if self.dead:
            return 503, {'status': 'dead', 'error': self.dead}
        if not self.ready:
            return 503, {'status': 'warming'}
        return 200, {'status': 'ok'}

    def metrics(self):
        m = self.engine.metrics()
        with self._active_lock:
            m['server_inflight'] = self._active
        m['draining'] = False
        m['requests_shed'] = 0
        m['role'] = 'mixed'
        return 200, m

    def admit(self, body: dict):
        """Parse and submit one /generate body. Returns (request, None)
        or (None, (status, error payload))."""
        if self.dead:
            return None, (500, {'error': f'engine died: {self.dead}'})
        if 'tokens' in body:
            try:
                tokens = [int(t) for t in body['tokens']]
            except (TypeError, ValueError):
                return None, (400, {'error': '"tokens" must be a list of '
                                             'token ids'})
        elif 'prompt' in body:
            tokens = self.tokenizer.encode(str(body['prompt']))
        else:
            return None, (400, {'error': 'need "tokens" or "prompt"'})
        try:
            req = self.engine.submit(
                tokens, max_new_tokens=body.get('max_new_tokens'),
                temperature=float(body.get('temperature', 0.0)))
        except (TypeError, ValueError) as e:
            return None, (400, {'error': str(e)})
        self._woken.set()
        return req, None

    def done_line(self, req) -> dict:
        return {'done': True, 'request_id': req.request_id,
                'finish_reason': req.finish_reason, 'ttft_s': req.ttft,
                'queue_wait_s': req.queue_wait,
                'cached_tokens': req.cached_tokens,
                'accepted_len_mean': None}

    def answer(self, req) -> dict:
        return {'request_id': req.request_id,
                'tokens': req.output_tokens,
                'text': self.tokenizer.decode(req.output_tokens),
                'finish_reason': req.finish_reason,
                'ttft_s': req.ttft,
                'queue_wait_s': req.queue_wait,
                'cached_tokens': req.cached_tokens,
                'accepted_len_mean': None}


class _Handler(http.server.BaseHTTPRequestHandler):
    srv: InferenceServer

    def log_message(self, fmt, *args) -> None:
        logger.debug('%s - ' + fmt, self.address_string(), *args)

    def _json(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        path = self.path.split('?', 1)[0]
        if path == '/health':
            self._json(*self.srv.health())
        elif path == '/metrics':
            self._json(*self.srv.metrics())
        else:
            self._json(404, {'error': f'no route {path}'})

    def do_POST(self) -> None:
        if self.path.split('?', 1)[0] != '/generate':
            self._json(404, {'error': f'no route {self.path}'})
            return
        with self.srv._active_lock:
            self.srv._active += 1
        try:
            self._generate()
        finally:
            with self.srv._active_lock:
                self.srv._active -= 1

    def _generate(self) -> None:
        try:
            n = int(self.headers.get('Content-Length') or 0)
            body = json.loads(self.rfile.read(n) or b'{}')
            if not isinstance(body, dict):
                raise ValueError('body is not a JSON object')
        except (ValueError, UnicodeDecodeError):
            self._json(400, {'error': 'malformed JSON'})
            return
        req, err = self.srv.admit(body)
        if err is not None:
            self._json(*err)
            return
        if body.get('stream'):
            self._stream(req)
            return
        while not req.wait_done(timeout=1.0):
            if self.srv.dead:
                self._json(500, {'error': f'engine died: {self.srv.dead}'})
                return
        self._json(200, self.srv.answer(req))

    def _stream(self, req) -> None:
        """JSON lines, one per token batch as the engine emits them, then
        the done line; the connection closes at the end (HTTP/1.0)."""
        self.send_response(200)
        self.send_header('Content-Type', 'application/jsonlines')
        self.end_headers()
        decoder = IncrementalDecoder(self.srv.tokenizer)
        sent = 0

        def write(obj: dict) -> None:
            self.wfile.write(json.dumps(obj).encode() + b'\n')
            self.wfile.flush()

        while True:
            if self.srv.dead:
                write({'error': f'engine died: {self.srv.dead}'})
                return
            done = req.done             # read BEFORE the token count:
            n = len(req.output_tokens)  # done => n is final
            if n > sent:
                write({'tokens': req.output_tokens[sent:n],
                       'text': decoder.feed(req.output_tokens, n)})
                sent = n
            if done and sent == len(req.output_tokens):
                tail = decoder.flush(req.output_tokens, sent)
                if tail:
                    write({'tokens': [], 'text': tail})
                write(self.srv.done_line(req))
                return
            req.wait_progress(sent, timeout=1.0)


def build_engine(model: str, slots: int, max_seq_len: int, page_size: int,
                 n_pages: Optional[int], device: str,
                 seed: int = 0) -> engine_lib.InferenceEngine:
    """Random weights for ``model`` drawn from ``seed`` on ``device``,
    and a paged engine over them."""
    dev = engine_lib.resolve_device(device)
    config = MODELS[model]()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = llama.init_params(config, gen, dev)
    return engine_lib.InferenceEngine(
        config, params,
        engine_lib.EngineConfig(
            n_slots=slots, max_seq_len=min(max_seq_len, config.max_seq_len),
            page_size=page_size, n_pages=n_pages),
        seed=seed, device=dev)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, required=True)
    parser.add_argument('--model', default='tiny', choices=sorted(MODELS))
    parser.add_argument('--slots', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=1024)
    parser.add_argument('--page-size', type=int, default=64)
    parser.add_argument('--n-pages', type=int, default=None,
                        help='KV pool pages incl. the sink page (default: '
                             'slots x max_seq_len / page_size + 1)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    parser.add_argument('--paged', action='store_true',
                        help='accepted for the reference server\'s '
                             'command line; the KV cache is always paged')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the random weights and of sampling')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    t0 = time.time()
    logger.warning('no checkpoint: serving random weights (%s) on %s',
                   args.model, args.device)
    engine = build_engine(args.model, args.slots, args.max_seq_len,
                          args.page_size, args.n_pages, args.device,
                          args.seed)
    logger.info('weights and KV pool ready in %.1fs', time.time() - t0)
    InferenceServer(engine).run(args.host, args.port)


if __name__ == '__main__':
    main()
