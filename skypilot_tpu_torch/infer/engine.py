"""Continuous-batching inference engine, paged flavor (counterpart of
``skypilot_tpu/infer/engine.py``, limited to the first slice of the port).

What this slice keeps from the reference:

- slots with FCFS admission from an inline waiting queue (the
  reference's ``sched/`` fcfs policy, round-robin chunk cursor included);
- chunked prefill with the page-aligned bucket ladder and the chunk-cap
  checks, over a paged KV cache whose page 0 is the garbage sink;
- one decode step over ALL slots with an ``active`` mask, as the
  reference does, so inactive slots write into the sink page or their own
  frontier and never advance their length;
- a synchronous loop (``pipeline_depth`` 0): each step reads its
  ``[2, slots]`` token pair back before the next one starts.

What it leaves out (ROADMAP queue 1): dispatch-ahead pipelining,
preemption and resume, speculative decoding, the fused mixed step, int8
KV, the prefix cache, the flight recorder and the SDC sentinel. Where the
reference preempts under page pressure, this engine finishes the request
with ``finish_reason='cache_full'``; the default pool
(``n_slots * max_pages_per_slot + 1`` pages) never runs dry.

Device placement is explicit: the engine runs on ``device`` (default
``'cuda'``) and raises if CUDA was asked for and is missing.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.infer import model as model_lib
from skypilot_tpu_torch.infer import paged_cache as paged_cache_lib
from skypilot_tpu_torch.infer import sampling as sampling_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import paged_attention as paged_attn


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    this process has none (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested but CUDA is not '
                           f'available; pass device="cpu" to run on the CPU')
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    max_seq_len: int = 2048
    prefill_buckets: Sequence[int] = (16, 64, 256)
    eos_id: Optional[int] = None
    max_new_tokens: int = 256
    top_k: int = 0
    cache_dtype: str = 'bfloat16'
    # Only 0 (the synchronous loop) exists in this slice.
    pipeline_depth: int = 0
    prefill_chunk: int = 256
    prefill_chunks_per_step: int = 4
    page_size: int = 64
    # Total pool pages (page 0 is the sink). None -> dense-equivalent
    # capacity, n_slots * max_seq_len / page_size + 1.
    n_pages: Optional[int] = None


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = dataclasses.field(default_factory=time.time)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    finish_reason: Optional[str] = None
    first_dispatch_at: Optional[float] = None
    # Prompt tokens served from a prefix cache; always 0 in this slice
    # (reported by the server like the reference's).
    cached_tokens: int = 0
    _cond: threading.Condition = dataclasses.field(
        default_factory=threading.Condition, repr=False, compare=False)

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def queue_wait(self) -> Optional[float]:
        if self.first_dispatch_at is None:
            return None
        return self.first_dispatch_at - self.submitted_at

    def _notify(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def wait_progress(self, n_seen: int,
                      timeout: Optional[float] = None) -> bool:
        """Block until more than ``n_seen`` tokens exist or the request
        finishes. Returns whether there is progress to read."""
        with self._cond:
            return self._cond.wait_for(
                lambda: len(self.output_tokens) > n_seen or self.done,
                timeout)

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self.done, timeout)


class InferenceEngine:
    """Slot-based continuous batching over one model replica.

    HTTP handler threads call ``submit()``/``metrics()``/``idle()``; one
    engine thread runs ``step()``. ``_lock`` guards the waiting queue,
    the slot list and the counters those readers see; device state and
    the page allocator belong to the engine thread."""

    def __init__(self, config: llama.LlamaConfig, params: llama.Params,
                 engine_config: Optional[EngineConfig] = None,
                 seed: int = 0, device='cuda') -> None:
        self.config = config
        self.ecfg = ecfg = engine_config or EngineConfig()
        self.device = resolve_device(device)
        if int(ecfg.pipeline_depth) != 0:
            raise ValueError(
                f'pipeline_depth={ecfg.pipeline_depth}: only the '
                f'synchronous loop (0) is ported so far; dispatch-ahead '
                f'decode is a follow-up (ROADMAP.md, queue 1 item 6)')
        if ecfg.max_seq_len > config.max_seq_len:
            raise ValueError(
                f'cache max_seq_len {ecfg.max_seq_len} exceeds model '
                f'max_seq_len {config.max_seq_len}')
        # Chunk buckets: the configured ladder clamped to the chunk cap,
        # then made page-granular (power-of-two multiples of the page
        # below the cap), exactly as the reference builds it.
        cap = min(ecfg.prefill_chunk, ecfg.max_seq_len)
        buckets = sorted({min(b, cap) for b in ecfg.prefill_buckets}
                         | {cap})
        self._chunk_cap = buckets[-1]
        if ecfg.max_seq_len % self._chunk_cap:
            raise ValueError(
                f'max_seq_len {ecfg.max_seq_len} must be a multiple of '
                f'the chunk size {self._chunk_cap}')
        page = ecfg.page_size
        if self._chunk_cap % page:
            raise ValueError(f'prefill chunk {self._chunk_cap} must be a '
                             f'multiple of page_size {page}')
        if self.device.type == 'cuda':
            paged_attn.check_cuda_shape(
                config.head_dim, config.n_heads // config.n_kv_heads, page)
        ladder = set()
        b = page
        while b < self._chunk_cap:
            ladder.add(b)
            b *= 2
        self._buckets = sorted({b for b in buckets if b % page == 0}
                               | ladder | {self._chunk_cap})
        max_pages_per_slot = ecfg.max_seq_len // page
        n_pages = ecfg.n_pages
        if n_pages is None:
            n_pages = ecfg.n_slots * max_pages_per_slot + 1
        min_pages = self._chunk_cap // page + 1
        if n_pages < min_pages:
            raise ValueError(
                f'n_pages={n_pages} cannot hold one prefill chunk '
                f'(needs >= {min_pages} incl. the sink page)')
        self.allocator = paged_cache_lib.PageAllocator(
            n_pages, page, ecfg.n_slots, max_pages_per_slot)
        self.cache = paged_cache_lib.init_paged_cache(
            config.n_layers, ecfg.n_slots, n_pages, page,
            config.n_kv_heads, config.head_dim,
            dtype=llama.torch_dtype(ecfg.cache_dtype), device=self.device)
        self.params = params
        self._rope = model_lib.rope_tables(config, self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        self._waiting: collections.deque = collections.deque()
        self._slots: List[Optional[Request]] = [None] * ecfg.n_slots
        # slot -> prompt tokens already prefilled; a slot decodes only
        # once its prompt is fully cached.
        self._prefilling: Dict[int, int] = {}
        self._rr = 0   # round-robin cursor over prefilling slots
        # Last sampled token per slot stays on the device: decode reads
        # it directly, the host sees tokens through the step's pair.
        self._last_dev = torch.zeros((ecfg.n_slots,), dtype=torch.int32,
                                     device=self.device)
        self._slot_len = np.zeros((ecfg.n_slots,), np.int64)
        self._temps = np.zeros((ecfg.n_slots,), np.float32)
        self._table_dev: Optional[torch.Tensor] = None
        self._table_version = -1
        self._active_dev: Optional[torch.Tensor] = None
        self._active_key: Optional[tuple] = None
        self._decode_steps = 0
        self._decode_tokens = 0
        self._decode_time = 0.0
        self._prefill_tokens = 0
        self._prefill_chunks = 0
        self._ttfts: collections.deque = collections.deque(maxlen=1024)
        self._queue_waits: collections.deque = collections.deque(
            maxlen=1024)

    # ---- submission ------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0) -> Request:
        """Queue a request. Raises ValueError for a prompt the cache or
        the page pool can never hold."""
        if not prompt_tokens:
            raise ValueError('empty prompt')
        total = len(prompt_tokens)
        if total > self.ecfg.max_seq_len - 1:
            raise ValueError(
                f'prompt ({total} tokens) exceeds cache capacity '
                f'({self.ecfg.max_seq_len - 1})')
        # Peak prefill allocation is bucket-padded (the final chunk
        # writes its whole padded bucket), plus one decode page.
        off = (total // self._chunk_cap) * self._chunk_cap
        rem = total - off
        peak = self.allocator.pages_needed(
            off + (self._bucket(rem) if rem else 0)) + 1
        if peak > self.allocator.n_pages - 1:
            raise ValueError(
                f'prompt ({total} tokens; {peak} pages incl. padding + '
                f'first decode page) exceeds the page pool '
                f'({self.allocator.n_pages - 1} usable pages x '
                f'{self.allocator.page_size})')
        if max_new_tokens is None:
            max_new_tokens = self.ecfg.max_new_tokens
        if max_new_tokens < 1:
            raise ValueError('max_new_tokens must be >= 1')
        if temperature < 0:
            raise ValueError('temperature must be >= 0')
        vocab = self.config.vocab_size
        if any(not 0 <= int(t) < vocab for t in prompt_tokens):
            raise ValueError(f'token ids must lie in [0, {vocab})')
        req = Request(request_id=next(self._ids),
                      prompt_tokens=list(map(int, prompt_tokens)),
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature))
        with self._lock:
            self._waiting.append(req)
        return req

    # ---- internals -------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise AssertionError(f'prompt length {n} has no bucket (max '
                             f'{self._buckets[-1]})')

    def _do_chunk(self, slot: int) -> Optional[bool]:
        """Advance one prefilling slot by ONE chunk. Returns True when
        the prompt is fully cached (the slot joins this step's decode),
        False on progress, None when the pool cannot cover the chunk
        right now (deferred)."""
        req = self._slots[slot]
        off = self._prefilling[slot]
        source = req.prompt_tokens
        n = len(source)
        remaining = n - off
        bucket = self._bucket(min(remaining, self._chunk_cap))
        while off + bucket > self.ecfg.max_seq_len:
            bucket = max(b for b in self._buckets if b < bucket)
        tl = min(remaining, bucket)
        if not self.allocator.extend(slot, off + bucket):
            return None
        if req.first_dispatch_at is None:
            req.first_dispatch_at = time.time()
            with self._lock:
                self._queue_waits.append(req.first_dispatch_at
                                         - req.submitted_at)
        padded = np.zeros((bucket,), np.int32)
        padded[:tl] = source[off:off + tl]
        table_row = torch.from_numpy(self.allocator.table()[slot]).to(
            self.device)
        tokens = torch.from_numpy(padded).to(self.device)
        self.cache, logits = model_lib.paged_prefill_chunk(
            self.config, self.params, self.cache, slot, table_row, tokens,
            off, tl, self._rope)
        tok = sampling_lib.sample(
            logits[None], self._generator,
            torch.tensor([req.temperature], dtype=torch.float32),
            top_k=self.ecfg.top_k)[0]
        self._last_dev[slot] = tok
        with self._lock:
            self._prefill_tokens += tl
            self._prefill_chunks += 1
        off += tl
        if off < n:
            self._prefilling[slot] = off
            return False
        del self._prefilling[slot]
        self._slot_len[slot] = n
        self._temps[slot] = req.temperature
        return True

    def _finished(self, req: Request, slot: int, token: int) -> bool:
        if self.ecfg.eos_id is not None and token == self.ecfg.eos_id:
            req.finish_reason = 'eos'
            return True
        if len(req.output_tokens) >= req.max_new_tokens:
            req.finish_reason = 'max_tokens'
            return True
        if self._slot_len[slot] + 1 >= self.ecfg.max_seq_len:
            req.finish_reason = 'cache_full'
            return True
        return False

    def _finish(self, slot: int, req: Request) -> None:
        with self._lock:
            req.finished_at = time.time()
            if req.first_token_at is None and req.output_tokens:
                req.first_token_at = req.finished_at
                self._ttfts.append(req.finished_at - req.submitted_at)
            self._slots[slot] = None
            self._prefilling.pop(slot, None)
            self.allocator.free(slot)
            self._slot_len[slot] = 0
            self.cache = paged_cache_lib.free_slot(self.cache, slot)
        req._notify()

    def _cache_full(self, slot: int) -> None:
        req = self._slots[slot]
        req.finish_reason = 'cache_full'
        self._finish(slot, req)

    def _ensure_decode_pages(self, decoding: List[int]) -> List[int]:
        """Every decoding slot must own the page its next token writes.
        Without preemption in this slice, a slot the pool cannot cover
        finishes 'cache_full'."""
        out = []
        for slot in decoding:
            if self.allocator.extend(slot, int(self._slot_len[slot]) + 1):
                out.append(slot)
            else:
                self._cache_full(slot)
        return out

    # ---- the step --------------------------------------------------------
    def step(self) -> int:
        """Refill free slots, advance at most ``prefill_chunks_per_step``
        prefill chunks (round-robin across prefilling slots), then decode
        one token for every fully prefilled slot and read the tokens back.
        Returns the number of slots worked on."""
        with torch.no_grad():
            return self._step()

    def _step(self) -> int:
        with self._lock:
            for slot in range(self.ecfg.n_slots):
                if self._slots[slot] is None:
                    if not self._waiting:
                        break
                    self._slots[slot] = self._waiting.popleft()
                    self._prefilling[slot] = 0
        just_prefilled: List[int] = []
        deferred: set = set()
        for _ in range(self.ecfg.prefill_chunks_per_step):
            candidates = sorted(s for s in self._prefilling
                                if s not in deferred)
            if not candidates:
                break
            self._rr = (self._rr + 1) % len(candidates)
            slot = candidates[self._rr]
            result = self._do_chunk(slot)
            if result is None:
                deferred.add(slot)
            elif result:
                just_prefilled.append(slot)
        if deferred and not any(r is not None and s not in self._prefilling
                                for s, r in enumerate(self._slots)):
            # Nothing decodes, so nothing will free pages: the youngest
            # other page-holding slot gives way to the oldest deferred
            # one (the reference preempts it; this slice finishes it), or
            # the deferred request alone has outgrown the pool.
            keep = min(deferred, key=lambda s: self._slots[s].submitted_at)
            victims = [s for s, r in enumerate(self._slots)
                       if r is not None and s != keep
                       and self.allocator.pages_of(s) > 0]
            if victims:
                self._cache_full(max(
                    victims, key=lambda s: self._slots[s].submitted_at))
            else:
                self._cache_full(keep)
        decoding = [s for s, r in enumerate(self._slots)
                    if r is not None and s not in self._prefilling]
        if decoding:
            decoding = self._ensure_decode_pages(decoding)
        if not decoding:
            return len(self._prefilling)
        t0 = time.perf_counter()
        self._decode(decoding, just_prefilled)
        with self._lock:
            self._decode_time += time.perf_counter() - t0
        return len(decoding) + len(self._prefilling)

    def _decode(self, decoding: List[int],
                just_prefilled: List[int]) -> None:
        """One decode step over every slot, then its host bookkeeping.
        The step's [2, slots] pair is read back at once: row 0 echoes the
        input tokens (the first token of each slot that finished prefill
        this step), row 1 holds the new tokens."""
        if self._table_version != self.allocator.version:
            self._table_dev = torch.from_numpy(self.allocator.table()).to(
                self.device)
            self._table_version = self.allocator.version
        key = tuple(decoding)
        if key != self._active_key:
            mask = np.zeros((self.ecfg.n_slots,), np.bool_)
            mask[decoding] = True
            self._active_dev = torch.from_numpy(mask).to(self.device)
            self._active_key = key
        assigned = [(s, self._slots[s]) for s in decoding]
        prefilled = [(s, self._slots[s]) for s in just_prefilled]
        logits, self.cache = model_lib.paged_decode_step(
            self.config, self.params, self.cache, self._table_dev,
            self._last_dev, self._rope, self._active_dev)
        sampled = sampling_lib.sample(logits, self._generator,
                                      torch.from_numpy(self._temps.copy()),
                                      top_k=self.ecfg.top_k)
        toks_out = torch.where(self._active_dev, sampled, self._last_dev)
        pair = torch.stack([self._last_dev, toks_out]).cpu().numpy()
        self._last_dev = toks_out
        now = time.time()
        touched: List[Request] = []
        with self._lock:
            self._decode_steps += 1
            for slot, req in prefilled:
                if req.done or self._slots[slot] is not req:
                    continue
                first = int(pair[0, slot])
                if req.first_token_at is None:
                    req.first_token_at = now
                    self._ttfts.append(now - req.submitted_at)
                req.output_tokens.append(first)
                self._decode_tokens += 1
                touched.append(req)
                if self._finished(req, slot, first):
                    # The token decoded this same step dies with the slot.
                    self._finish(slot, req)
            for slot, req in assigned:
                if req.done or self._slots[slot] is not req:
                    continue
                token = int(pair[1, slot])
                req.output_tokens.append(token)
                self._slot_len[slot] += 1
                self._decode_tokens += 1
                touched.append(req)
                if self._finished(req, slot, token):
                    self._finish(slot, req)
        for req in touched:
            if not req.done:
                req._notify()

    # ---- driving ---------------------------------------------------------
    def idle(self) -> bool:
        with self._lock:
            return (not self._waiting
                    and all(r is None for r in self._slots))

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if self.idle():
                return
            self.step()

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0) -> List[Request]:
        """Batch convenience: submit all, run to completion."""
        reqs = [self.submit(p, max_new_tokens, temperature)
                for p in prompts]
        self.run_until_idle()
        return reqs

    # ---- metrics ---------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            ttfts = sorted(self._ttfts)
            waits = sorted(self._queue_waits)
            c = dict(steps=self._decode_steps, tokens=self._decode_tokens,
                     time=self._decode_time,
                     prefill_tokens=self._prefill_tokens,
                     prefill_chunks=self._prefill_chunks,
                     waiting=len(self._waiting),
                     active=sum(1 for r in self._slots if r is not None),
                     pages_free=self.allocator.free_pages)
        return {
            'decode_steps': c['steps'],
            'decode_tokens': c['tokens'],
            'decode_tokens_per_sec': (c['tokens'] / c['time']
                                      if c['time'] else 0.0),
            'tokens_per_step': (round(c['tokens'] / c['steps'], 4)
                                if c['steps'] else None),
            'prefill_tokens': c['prefill_tokens'],
            'prefill_chunks': c['prefill_chunks'],
            'ttft_p50_s': ttfts[len(ttfts) // 2] if ttfts else None,
            'queue_wait_p50_ms': (round(waits[len(waits) // 2] * 1e3, 3)
                                  if waits else None),
            'scheduler': 'fcfs',
            'num_waiting': c['waiting'],
            'num_active': c['active'],
            'pipeline_depth': 0,
            'paged': True,
            'page_size': self.allocator.page_size,
            'pages_total': self.allocator.n_pages,
            'pages_free': c['pages_free'],
            'kv_dtype': self.ecfg.cache_dtype,
            'device': str(self.device),
            # Launches of each hand-written kernel in this process (the
            # wrappers' counters): shows the path ran through them.
            'kernel_launches': dict(paged_attn.launches),
        }
