"""Continuous-batching inference engine, paged flavor (counterpart of
``skypilot_tpu/infer/engine.py``).

What the port keeps from the reference:

- slots filled by a pluggable scheduler (``sched/``: fcfs, deadline,
  wfq) with bounded admission (``AdmissionError``, carrying a
  queue-drain Retry-After), per-tenant accounting, cancel and
  wall-clock deadlines, queued or active;
- chunked prefill with the chunk-cap checks, over a paged KV cache whose
  page 0 is the garbage sink (with the page-aligned bucket ladder) or
  over the dense per-slot cache;
- one decode step over ALL slots with an ``active`` mask, as the
  reference does, so inactive slots write into the sink page or their own
  frontier and never advance their length;
- recompute preemption under page pressure: the scheduler's victim goes
  back to the front of the queue and resumes by prefilling prompt +
  generated tokens (its TTFT is not recorded again), through the
  reference's drain -> preempt -> ``cache_full`` ladder;
- self-speculative decoding (``spec_k`` > 0): the prompt-lookup drafter
  proposes up to the scheduler's ``spec_budget`` tokens per greedy slot,
  one verify step scores them all, the longest exact-greedy prefix plus
  one corrected token lands, and rejected-draft pages roll back; greedy
  outputs equal speculation-off's token for token;
- int8 KV pages (``kv_dtype='int8'``): quantized on write, dequantized in
  the kernels;
- int8 weights (``quantize``): the params quantized per output channel
  at construction (``ops/quant.py``), every dense product a W8A16 kernel
  launch on the card;
- the dispatch-ahead loop (``pipeline_depth``, default 1): step N + 1 is
  dispatched before step N's token rows are read back; each dispatched
  step copies its rows into a pinned host ring of ``depth + 1`` buffers
  and records an event, the host syncs on that event alone, and every
  record keeps its slot -> request map from dispatch time (a token whose
  slot changed hands meanwhile is dropped). Page, preempt and finish
  decisions drain the in-flight steps first, so greedy outputs are the
  same at every depth.

- fused mixed steps (``fused_prefill``): while anything decodes, ONE
  prefill chunk rides the decode dispatch as one mixed step
  (``model.paged_mixed_step``) instead of standalone chunks between
  decode steps, and speculation stands down for that step; greedy
  outputs are the same fused on and off;
- the flight recorder (``stepline``): a ring of per-step records (stage
  intervals, batch and chunk sizes, page pressure, queue depth), a ring
  of per-program records (each dispatched program's rows, chunks and
  KV tokens read, its device time and the idle gap before it, read from
  CUDA events only after a wait the step loop makes anyway) and
  per-request timeline events, ``stepline_snapshot()`` /
  ``stepline_summary()``, and anomaly dumps (TTFT SLO, preemption,
  ``cache_full``, admission shed, SDC) into the span store, written off
  the engine lock; pure observation;
- the SDC sentinel (``sdc_sentinel``): a per-slot all-finite row of the
  step's logits rides the token pair as its last row; a non-finite slot
  finishes ``'sdc'`` and flips ``integrity_suspect()`` for good;
- ``resume_tokens`` on ``submit``: a stream continued from tokens already
  delivered elsewhere (pre-seeded into the output and prefilled with the
  prompt);
- the shared-prefix KV cache (``prefix_cache``, ``prefix_cache.py``): a
  finished, cut or preempted request donates its full pages to a radix
  tree, a new request attaches the longest cached page-aligned prefix of
  its source and prefills only from there (its first chunk runs at the
  matched offset through the same chunk programs), cached pages are
  LRU-evicted under page pressure before anyone is preempted, and every
  write range is copy-on-written private before dispatch (the chunk's,
  decode's and a verify run's); greedy outputs are the same on and off;
- KV prefix transfer jobs: ``request_kv_export`` serializes a cached
  prefix into the int8 wire format (``kv_wire.py``), ``request_kv_import``
  grafts a donor's blob into the pool and the tree, both serviced on the
  engine thread at the start of a step; ``kv_index_snapshot`` publishes
  the tree's chained-hash index for the serve load balancer.

The reference jits each step into one program. The port's counterpart is
a CUDA graph per step program: the decode step (model, sampling and the
token pair), the verify step (model, acceptance and the device-side
advance), the standalone prefill chunk (model, the first-token sample
into the last-token vector) and the mixed step, captured once per (kind,
queries per slot or chunk bucket, whether anything samples) and replayed
every step, reading fixed device buffers that the host refreshes with
``copy_`` (last tokens, block table, active mask, temperatures, drafts;
for a chunk its slot, offset, true length, temperature, table row and
tokens, packed in one int32 buffer). A chunk reads its offset and length
on the device (the prefill kernel's device-scalar entry), so one graph
serves every chunk of its bucket. A key's first run goes eagerly on the
capture stream (the warm-up), its second is captured and replayed.
Graphs are on whenever the device is CUDA (``EngineConfig.cuda_graphs``
turns them off for the on == off gate); on the CPU the same
static-buffer code runs eagerly. A capture that fails raises; nothing
falls back to eager. The recorder and the sentinel touch nothing that is
captured: the sentinel's row is part of each program. The prefix cache
adds no program: a page copy-on-write and a KV import write the pool
tensors in place, eagerly on the step's stream, never rebinding them (the
graphs keep their pointers).

The dense flavor (``paged=False``, the reference's default) keeps every
slot at ``max_seq_len`` rows (``cache.py``): no allocator, so no page
pressure, preemption, prefix cache or int8 pages, and the reference's
chunk buckets with no page ladder. Its step programs are the same CUDA
graphs over the dense steps of ``model.py``, which run the paged kernels
through the cache's identity block table. :class:`EnginePool` routes each
request to the smallest of several dense engines (tiers) whose cache fits
it, the reference's two-tier KV for long context.

Tensor parallelism (dense cache only, as the reference's engine
allows): the engine runs as one rank of the ``tp``-rank
``torch.distributed`` group passed as ``group`` (a
``parallel.mesh.TPGroup``; ``EngineConfig.tp``, the reference's field,
may name its size), holding its Megatron slices of the weights (a
whole tree passed in is sliced here, the reference's ``_shard_tp``;
``init_params_sharded`` and ``quant.init_params_quantized`` draw a
rank's slices directly) and ``n_kv_heads / tp`` KV heads of the cache; the steps call the collectives
(``model.py``). Every rank runs the same host decisions on the same
submissions (``multihost.py`` broadcasts them) and samples from the same
full logits with the same generator, so the ranks' tokens agree, which
``output_digest`` lets the lockstep loop check every tick. CUDA graphs
capture the steps when the group can be captured (NCCL, or one rank); a
``gloo`` group over a card stages its collectives through the host and
needs ``cuda_graphs=False``, asked for explicitly.

Device placement is explicit: the engine runs on ``device`` (default
``'cuda'``) and raises if CUDA was asked for and is missing.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.infer import cache as cache_lib
from skypilot_tpu_torch.infer import drafter as drafter_lib
from skypilot_tpu_torch.infer import kv_wire
from skypilot_tpu_torch.infer import model as model_lib
from skypilot_tpu_torch.infer import paged_cache as paged_cache_lib
from skypilot_tpu_torch.infer import prefix_cache as prefix_cache_lib
from skypilot_tpu_torch.infer import sampling as sampling_lib
from skypilot_tpu_torch.infer import sched as sched_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import stepline as stepline_lib
from skypilot_tpu_torch.ops import paged_attention as paged_attn
from skypilot_tpu_torch.ops import quant as quant_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sharding_lib
from skypilot_tpu_torch.utils import prefix_hash

# The server catches admission refusals by this name, as the
# reference's does.
AdmissionError = sched_lib.AdmissionError


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    this process has none (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested but CUDA is not '
                           f'available; pass device="cpu" to run on the CPU')
    return dev


def _captured_launches() -> Dict[str, int]:
    """Every kernel wrapper's launches recorded under CUDA graph capture
    so far (the paged attention kernels' and the int8-weight product's)."""
    return {**paged_attn.captured, **quant_lib.captured}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    max_seq_len: int = 2048
    prefill_buckets: Sequence[int] = (16, 64, 256)
    eos_id: Optional[int] = None
    max_new_tokens: int = 256
    top_k: int = 0
    cache_dtype: str = 'bfloat16'
    # Dispatch-ahead decode: up to this many steps in flight on the
    # device before the host reads one back. 0 = the synchronous loop.
    # Greedy outputs are the same at any depth.
    pipeline_depth: int = 1
    prefill_chunk: int = 256
    prefill_chunks_per_step: int = 4
    # Paged KV cache (paged_cache.py): slots share a pool of fixed-size
    # pages, device memory follows the tokens in flight, and a dry pool
    # preempts. Off (the reference's default): the dense cache
    # (cache.py), max_seq_len rows per slot, whose page view the same
    # attention kernels read through an identity block table.
    paged: bool = False
    # The paged cache's page (the dense cache picks its view's page).
    page_size: int = 64
    # Total pool pages (page 0 is the sink). None -> dense-equivalent
    # capacity, n_slots * max_seq_len / page_size + 1. A smaller pool
    # preempts under pressure.
    n_pages: Optional[int] = None
    # Shared-prefix KV reuse (prefix_cache.py): finished, cut and
    # preempted requests donate their full pages to a radix tree keyed by
    # per-page token blocks; a new request attaches the longest cached
    # page-aligned prefix of its prompt (refcount++) and prefills only
    # from the match boundary. Unreferenced cached pages are LRU-evicted
    # strictly under page pressure, before preemption is considered.
    # Greedy outputs are the same with the cache on and off.
    prefix_cache: bool = False
    # KV page value dtype: 'bfloat16' (pages of cache_dtype) or 'int8'
    # (int8 values plus one fp32 absmax scale per row per KV head,
    # quantized on write and dequantized in the kernels: about half the
    # KV bytes per token). Greedy outputs under int8 are not
    # bit-identical to bf16; the reference pins the tolerance.
    kv_dtype: str = 'bfloat16'
    # Admission bounds on the waiting queue (requests, and prompt +
    # generated tokens); past them submit() raises AdmissionError. None
    # = unbounded. Under 'wfq' they split into per-tenant quotas.
    max_queue_requests: Optional[int] = None
    max_queue_tokens: Optional[int] = None
    # Self-speculative decoding: a prompt-lookup drafter proposes up to
    # spec_k tokens per greedy slot and one verify step scores them all;
    # a step emits 1..spec_k+1 tokens per slot and greedy outputs stay
    # identical to spec_k=0. 0 = off. Sampled slots never draft.
    spec_k: int = 0
    # Longest trailing n-gram the drafter matches (it falls back to
    # shorter grams down to 1).
    spec_ngram: int = 3
    # Scheduling policy (sched/): 'fcfs', 'deadline' or 'wfq'.
    scheduler: str = 'fcfs'
    # tenant -> relative weight for 'wfq' (unknown tenants weigh 1.0).
    tenant_weights: Optional[Any] = None
    # Capture the step programs (decode, verify, prefill chunk, mixed)
    # as CUDA graphs on a CUDA device (ignored on the CPU). Off only to
    # hold graph-on against graph-off.
    cuda_graphs: bool = True
    # Fused mixed steps: while any slot decodes, ONE prefill chunk rides
    # the decode dispatch (model.paged_mixed_step) instead of standalone
    # chunks landing between decode steps, so the decode batch's time
    # between tokens stops absorbing whole chunks. Greedy outputs are the
    # same fused on and off; only step timing changes.
    fused_prefill: bool = False
    # Flight recorder (observability/stepline.py): per-step records and
    # per-request events, GET /debug/stepline, anomaly dumps into the
    # span store. Pure observation: outputs are the same on and off.
    stepline: bool = True
    # Ring capacity in step records (None -> SKY_TPU_STEPLINE_CAP or
    # 1024); the request-event ring holds 4x as many.
    stepline_cap: Optional[int] = None
    # TTFT SLO in seconds: a slower first token triggers an anomaly
    # dump. None = no SLO trigger.
    ttft_slo_s: Optional[float] = None
    # On-device SDC sentinel: each step's per-slot all-finite flags ride
    # the readback pair as its last row (no extra transfer, no extra
    # program). A non-finite hit finishes the slot 'sdc' and marks the
    # engine integrity_suspect (one-way). Greedy outputs and
    # decode_steps are the same on and off.
    sdc_sentinel: bool = True
    # int8 weight-only quantization (ops/quant.py): the params are
    # quantized at construction unless they already are; every dense
    # product then runs the W8A16 kernel on the card, streaming half the
    # weight bytes a step.
    quantize: bool = False
    # Tensor-parallel ranks (dense cache only), the reference's field. The
    # engine is one rank of the group passed to it as ``group`` and takes
    # its size from there: left at 1, this reads as the group's size; set,
    # it must equal it.
    tp: int = 1


def init_params_sharded(config: llama.LlamaConfig, tp: int, rank: int,
                        seed: int = 0, device='cuda') -> llama.Params:
    """Rank ``rank``'s slices of the random weights drawn from ``seed`` on
    ``device`` (the reference's ``init_params_sharded``): each leaf is
    drawn whole, its slice kept and the rest dropped before the next
    leaf, so a rank holds 1/tp of the weights plus one leaf at a time.
    The values are those of the unsharded draw on the same device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return llama.init_params(
        config, gen, dev,
        keep=lambda path, leaf: sharding_lib.shard_leaf(path, leaf, rank, tp))


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
    # Fair-queueing identity (X-SkyTpu-Tenant end to end).
    tenant: str = sched_lib.DEFAULT_TENANT
    # When the first prefill chunk dispatched (not re-stamped on a
    # preemption resume): submit -> here is the queue wait.
    first_dispatch_at: Optional[float] = None
    # Prompt tokens served from the prefix cache (the longest attach of
    # this request's residencies, capped at the prompt).
    cached_tokens: int = 0
    # Tokens this request resumed from (a stream continued after its
    # replica died): pre-seeded into output_tokens and prefilled with the
    # prompt; the server never emits them again.
    resumed_from: int = 0
    # Absolute wall-clock cutoff (time.time()); past it the engine
    # finishes the request ('deadline'), queued or active. None = none.
    deadline: Optional[float] = None
    # Set by cancel(); only the engine thread acts on it.
    cancelled: bool = False
    # Per-request speculation opt-out (body {"spec": false}): never
    # drafted for; outputs are the same either way.
    spec: bool = True
    # Verify steps in which this request drafted, and the tokens those
    # steps emitted for it (engine thread only): the per-request
    # accepted_len_mean.
    spec_steps: int = 0
    spec_emitted: int = 0
    # The drafter's incremental n-gram index over prompt + output; it
    # survives preemption with the request.
    draft_memo: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
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


@dataclasses.dataclass
class _ChunkPlan:
    """A prepared prefill chunk, not yet dispatched: page coverage
    secured, bucket chosen, tokens padded. It dispatches standalone
    (``_dispatch_chunk_plan``) or fused into the decode dispatch
    (``_dispatch_mixed``). Engine thread only."""
    slot: int
    req: Request
    off: int           # prefill offset this chunk starts at
    bucket: int        # padded chunk length (the program's shape)
    tl: int            # valid tokens in the chunk
    total: int         # prompt + resume tokens the slot must cache
    padded: np.ndarray
    table_row: np.ndarray   # the slot's block-table row at preparation


class _KVJob:
    """One queued KV transfer (export or import). Any thread enqueues
    (``request_kv_export`` / ``request_kv_import``); only the stepping
    thread services it, since the tree and the page pool are engine-thread
    confined. The waiter blocks on the event."""

    def __init__(self, kind: str, payload: Any,
                 fetch_s: float = 0.0) -> None:
        self.kind = kind          # 'export' | 'import'
        self.payload = payload    # export: token list; import: blob
        self.fetch_s = fetch_s    # import: the upstream fetch's wall time
        self.result: Any = None
        self.error: Optional[Exception] = None
        self._done = threading.Event()

    def finish(self, result: Any = None,
               error: Optional[Exception] = None) -> None:
        self.result, self.error = result, error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


@dataclasses.dataclass
class _StepProgram:
    """One step kind's program: its runs so far and, once captured, the
    CUDA graph, its output pair and the kernel launches one replay
    makes."""
    runs: int = 0
    graph: Any = None
    out: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class InferenceEngine:
    """Slot-based continuous batching over one model replica.

    HTTP handler threads call ``submit()``/``cancel()``/``metrics()``/
    ``idle()``; one engine thread runs ``step()``. ``_lock`` guards the
    scheduler (which owns the waiting queue), the slot list and the
    counters those readers see; device state, the in-flight queue and
    the page allocator belong to the engine thread."""

    def __init__(self, config: llama.LlamaConfig, params: llama.Params,
                 engine_config: Optional[EngineConfig] = None,
                 seed: int = 0, device='cuda',
                 group: Optional[mesh_lib.TPGroup] = None) -> None:
        self.config = config
        self.ecfg = ecfg = engine_config or EngineConfig()
        self.device = resolve_device(device)
        tp = group.world if group is not None else int(ecfg.tp)
        self._group = self._check_tp(tp, group)
        if int(ecfg.pipeline_depth) < 0:
            raise ValueError(f'pipeline_depth must be >= 0, got '
                             f'{ecfg.pipeline_depth}')
        if ecfg.max_seq_len > config.max_seq_len:
            raise ValueError(
                f'cache max_seq_len {ecfg.max_seq_len} exceeds model '
                f'max_seq_len {config.max_seq_len}')
        # Chunk buckets: the configured ladder clamped to the chunk cap
        # (non-final chunks always take the cap, so cap | max_seq_len
        # keeps every chunk inside the cache), then, on the paged cache,
        # made page-granular (power-of-two multiples of the page below
        # the cap), exactly as the reference builds them.
        cap = min(ecfg.prefill_chunk, ecfg.max_seq_len)
        self._buckets = sorted({min(b, cap) for b in ecfg.prefill_buckets}
                               | {cap})
        self._chunk_cap = self._buckets[-1]
        if ecfg.max_seq_len % self._chunk_cap:
            raise ValueError(
                f'max_seq_len {ecfg.max_seq_len} must be a multiple of '
                f'the chunk size {self._chunk_cap}')
        on_cuda = self.device.type == 'cuda'
        # This rank's KV heads.
        hkv = config.n_kv_heads // tp
        self.allocator: Optional[paged_cache_lib.PageAllocator] = None
        if ecfg.paged:
            page = ecfg.page_size
            if self._chunk_cap % page:
                raise ValueError(f'prefill chunk {self._chunk_cap} must be '
                                 f'a multiple of page_size {page}')
            if ecfg.kv_dtype not in ('bfloat16', 'int8'):
                raise ValueError(f"kv_dtype must be 'bfloat16' or 'int8', "
                                 f'got {ecfg.kv_dtype!r}')
            ladder = set()
            b = page
            while b < self._chunk_cap:
                ladder.add(b)
                b *= 2
            self._buckets = sorted({b for b in self._buckets if b % page == 0}
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
                dtype=(torch.int8 if ecfg.kv_dtype == 'int8'
                       else llama.torch_dtype(ecfg.cache_dtype)),
                device=self.device)
        else:
            if ecfg.kv_dtype != 'bfloat16':
                raise ValueError(
                    'kv_dtype=int8 requires the paged KV cache '
                    '(EngineConfig.paged=True): quantization is at page '
                    'granularity')
            if ecfg.prefix_cache:
                raise ValueError(
                    'prefix_cache requires the paged KV cache '
                    '(EngineConfig.paged=True): sharing is at page '
                    'granularity')
            # No allocator: a slot owns max_seq_len rows for good, so
            # there is no page pressure, preemption or cache-full ladder.
            # The kernels read the cache through a page view whose page
            # divides every chunk offset.
            page = cache_lib.dense_page(ecfg.max_seq_len, self._chunk_cap)
            max_pages_per_slot = ecfg.max_seq_len // page
            self.cache = cache_lib.init_cache(
                config.n_layers, ecfg.n_slots, ecfg.max_seq_len,
                hkv, config.head_dim,
                dtype=llama.torch_dtype(ecfg.cache_dtype),
                device=self.device, page=page)
        # The page the attention kernels read: the pool's, or the dense
        # cache's view.
        self._page = page
        if on_cuda:
            paged_attn.check_cuda_shape(
                config.head_dim, config.n_heads // config.n_kv_heads, page)
        if ecfg.quantize and not quant_lib.is_quantized(params):
            if tp > 1 and not sharding_lib.is_whole(params, config):
                raise ValueError(
                    'quantize=True takes a whole bf16 tree at tp > 1 (a '
                    'row-parallel weight\'s scale covers the whole '
                    'contraction axis); quantize before sharding')
            params = quant_lib.quantize_params(params)
        if tp > 1:
            params = self._shard_tp(params)
        self.params = params
        self._param_bytes = quant_lib.param_bytes(params)
        self._rope = model_lib.rope_tables(config, self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        self._sched = sched_lib.make(
            ecfg.scheduler, sched_lib.SchedulerConfig(
                max_queue_requests=ecfg.max_queue_requests,
                max_queue_tokens=ecfg.max_queue_tokens,
                tenant_weights=ecfg.tenant_weights))
        self._slots: List[Optional[Request]] = [None] * ecfg.n_slots
        # Shared-prefix radix tree over the page pool (None = disabled).
        self.prefix: Optional[prefix_cache_lib.PrefixCache] = (
            prefix_cache_lib.PrefixCache(self.allocator)
            if ecfg.prefix_cache else None)
        # Slots that already ran their prefix match for the current
        # residency (a rolled-back attach discards the entry so the retry
        # re-matches), and slots mapping attached (possibly shared) pages:
        # the only ones _unshare_write_range must scan.
        self._matched: set = set()
        self._attached_slots: set = set()
        # KV transfer jobs, serviced at step start; transfer counters and
        # a bounded duration window for the p99; the last published index
        # copy (gen, crc, page, journal, hashes) HTTP threads read.
        self._kv_jobs: collections.deque = collections.deque()
        self._kv_transfers = 0
        self._kv_transfer_bytes = 0
        self._kv_transfer_failures = 0
        self._kv_transfer_window: collections.deque = collections.deque(
            maxlen=512)
        self._kv_index_pub: tuple = (0, 0, page if ecfg.paged else 0, (),
                                     frozenset())
        # slot -> tokens already prefilled; a slot decodes only once its
        # prompt (plus, after a preemption, its output) is fully cached.
        self._prefilling: Dict[int, int] = {}
        self._slot_len = np.zeros((ecfg.n_slots,), np.int64)
        self._temps = np.zeros((ecfg.n_slots,), np.float32)
        # ---- static device inputs of the step programs ----------------
        # A captured graph reads these very tensors, so they are only
        # ever written in place. The last sampled token per slot stays
        # on the device: decode reads it directly, the host sees tokens
        # through the step's pair.
        slots = ecfg.n_slots
        dev = self.device
        self._last = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # The block table the decode and verify steps read (the dense
        # cache carries its own identity table).
        self._table = (torch.zeros((slots, max_pages_per_slot),
                                   dtype=torch.int32, device=dev)
                       if ecfg.paged else self.cache.tables)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._temps_dev = torch.zeros((slots,), dtype=torch.float32,
                                      device=dev)
        self._draft_lens = torch.zeros((slots,), dtype=torch.int32,
                                       device=dev)
        self._drafts: Dict[int, torch.Tensor] = {}   # R -> [slots, R-1]
        # The dense slots' identity rows, staged as a paged chunk stages
        # its table row.
        self._dense_rows = (None if ecfg.paged
                            else self.cache.tables.cpu().numpy())
        # A chunk's inputs, packed in one int32 buffer so that one copy
        # stages them: [0] slot, [1] offset, [2] true_len, [3] the
        # temperature's fp32 bits, then the table row (max pages), then
        # the tokens (room for the largest bucket; a bucket reads its
        # prefix).
        self._chunk_in = torch.zeros((4 + max_pages_per_slot
                                      + self._chunk_cap,),
                                     dtype=torch.int32, device=dev)
        self._table_version = -1
        self._active_key: Optional[tuple] = None
        self._temps_dirty = True
        # ---- step programs (CUDA graphs on the card) ------------------
        self._graphs_on = on_cuda and bool(ecfg.cuda_graphs)
        if self._graphs_on and not self._group.capturable:
            raise ValueError(
                f'a {self._group.backend} group of {tp} ranks cannot be '
                f'captured in CUDA graphs (its collectives stage through '
                f'the host): pass cuda_graphs=False, or use nccl')
        self._programs: Dict[tuple, _StepProgram] = {}
        self._capture_stream = torch.cuda.Stream(dev) if on_cuda else None
        if on_cuda:
            # A graph keeps the split kernels' workspace pointers: size
            # them for the widest verify step and the largest chunk
            # before any capture.
            paged_attn.reserve_split_scratch(
                dev, slots, hkv, config.head_dim, max_pages_per_slot)
            paged_attn.reserve_prefill_scratch(
                dev, hkv,
                self._chunk_cap * (config.n_heads // config.n_kv_heads),
                config.head_dim, max_pages_per_slot)
        # ---- dispatch-ahead state -------------------------------------
        # Dispatched, unread steps (<= _depth of them), oldest first:
        # (host rows, event, decoded, prefilled, spec_r), where decoded
        # and prefilled pin the slot -> request map at dispatch time.
        self._depth = int(ecfg.pipeline_depth)
        self._queue: collections.deque = collections.deque()
        # Tokens in flight per slot: page coverage must reach what the
        # device will have written before the host reads it.
        self._inflight_tok = [0] * slots
        self._ring: List[torch.Tensor] = []
        self._ring_i = 0
        self._decode_steps = 0
        self._decode_tokens = 0
        self._decode_time = 0.0
        self._prefill_tokens = 0
        self._prefill_chunks = 0
        self._preemptions = 0
        # ---- fused mixed steps ------------------------------------------
        self._fused = bool(ecfg.fused_prefill)
        # Mixed dispatches, and steps where an active decode batch waited
        # on a standalone chunk (the stall fused mode removes).
        self._fused_steps = 0
        self._stall_steps = 0
        # Slots whose prompt finished prefilling without joining a decode
        # dispatch (fused mode, the decode batch gone under page
        # pressure): their first token sits in _last and surfaces through
        # the next dispatch's pair row 0.
        self._pending_first: Dict[int, Request] = {}
        # ---- SDC sentinel -----------------------------------------------
        # _sentinel is fixed at init (the programs carry the row);
        # _integrity_suspect is a one-way flag the server reads lock-free.
        self._sentinel = bool(ecfg.sdc_sentinel)
        self._integrity_suspect = False
        self._sdc_events = 0
        # ---- flight recorder --------------------------------------------
        # _sl_on is fixed at init and read lock-free; the rings behind it
        # are guarded by _lock. The current step's stage intervals
        # (engine thread only; None outside a recorded step): its
        # perf_counter start, (stage, offset, seconds) in the order they
        # ran, the programs it dispatched and its decode batch.
        self._sl_on = bool(ecfg.stepline)
        self._stepline = (stepline_lib.StepRecorder(ecfg.stepline_cap)
                          if self._sl_on else None)
        self._pending_dumps: List[tuple] = []
        self._sl_t0 = 0.0
        self._sl_stages: Optional[List[tuple]] = None
        self._sl_programs = 0
        self._sl_batch = 0
        # Program records whose CUDA events are unread, in dispatch order:
        # (fields, start event, end event, the previous program's end
        # event); and the last program's end (its event, on the CPU its
        # perf_counter time), None after an idle tick (the device had no
        # work: the next gap is not the engine's).
        self._sl_pending: collections.deque = collections.deque()
        self._sl_prev_end: Any = None
        # Queued requests dropped because the client went away,
        # requests cut by their deadline, active requests cancelled.
        self._abandoned = 0
        self._expired = 0
        self._cancelled = 0
        # Deadline and cancel sweeps read the local wall clock.
        self.wallclock_cancel = True
        self._ttfts: collections.deque = collections.deque(maxlen=1024)
        self._queue_waits: collections.deque = collections.deque(
            maxlen=1024)
        self._drafter = drafter_lib.PromptLookupDrafter(
            max_ngram=max(1, int(ecfg.spec_ngram)))
        # Verify accounting: steps, drafting (slot, step) lanes, drafted,
        # accepted and emitted tokens of those lanes.
        self._spec_steps = 0
        self._spec_slot_steps = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_emitted = 0
        self._spec_k = 0
        self.set_spec_k(ecfg.spec_k)

    # ---- tensor parallelism ---------------------------------------------
    def _check_tp(self, tp: int,
                  group: Optional[mesh_lib.TPGroup]) -> mesh_lib.TPGroup:
        """The reference's ``tp`` rules (dense cache only; ``tp`` divides
        the heads, KV heads, ffn and vocabulary), then the group: one of
        ``tp`` ranks (a single-rank group when ``tp`` is 1)."""
        if tp < 1:
            raise ValueError(f'tp must be >= 1, got {tp}')
        if tp > 1 and self.ecfg.paged:
            raise ValueError(
                'paged KV is single-device for now; use the dense cache '
                'for tp > 1')
        sharding_lib.check_divisible(self.config, tp)
        if group is None:
            if tp > 1:
                raise ValueError(
                    f'tp={tp} needs the process group of its ranks '
                    f'(parallel.mesh.tp_group) as group=')
            return mesh_lib.single(self.device)
        if self.ecfg.tp not in (1, tp):
            raise ValueError(f'tp={self.ecfg.tp} but the group has {tp} '
                             f'ranks')
        return group

    def _shard_tp(self, params: llama.Params) -> llama.Params:
        """This rank's slices of the weights on the engine's device (the
        reference's ``_shard_tp``): a whole tree is sliced by the Megatron
        rules (``parallel/sharding.py``); a tree already sliced for this
        rank (``init_params_sharded``, another tier's params) is kept."""
        g = self._group
        if sharding_lib.is_whole(params, self.config):
            params = sharding_lib.shard_params(params, g.rank, g.world)

        def place(leaf):
            if isinstance(leaf, quant_lib.QuantArray):
                return quant_lib.QuantArray(q=leaf.q.to(self.device),
                                            scale=leaf.scale.to(self.device))
            return leaf.to(self.device)
        return sharding_lib.map_tree(lambda _, leaf: place(leaf), params)

    # ---- runtime knobs ---------------------------------------------------
    def set_spec_k(self, k: int) -> None:
        """Runtime draft width (0 = off); greedy outputs are the same at
        every width. Each width is its own verify program. On CUDA a
        width the verify kernel does not take raises."""
        k = max(0, int(k))
        if k and self.device.type == 'cuda':
            paged_attn.check_cuda_shape(
                self.config.head_dim,
                self.config.n_heads // self.config.n_kv_heads,
                self._page, r_queries=k + 1)
        with self._lock:
            self._spec_k = k

    def set_pipeline_depth(self, depth: int) -> None:
        """Change the dispatch-ahead depth at runtime (in-flight steps
        beyond it are consumed now)."""
        self._depth = max(0, int(depth))
        while len(self._queue) > self._depth:
            self._consume_one()

    def set_wallclock_cancel(self, enabled: bool) -> None:
        """Enable/disable the deadline and client-cancel sweeps."""
        self.wallclock_cancel = bool(enabled)

    def set_scheduler(self, name: str, tenant_weights=None) -> None:
        """Swap the scheduling policy at runtime. Queued requests
        migrate in the old policy's service order; per-tenant windows
        and counters restart with the new policy."""
        cfg = sched_lib.SchedulerConfig(
            max_queue_requests=self.ecfg.max_queue_requests,
            max_queue_tokens=self.ecfg.max_queue_tokens,
            tenant_weights=(tenant_weights if tenant_weights is not None
                            else self.ecfg.tenant_weights))
        with self._lock:
            new = sched_lib.make(name, cfg)
            old = self._sched
            while True:
                req = old.pop_next()
                if req is None:
                    break
                new.enqueue(req)
            self._sched = new

    def set_tenant_weights(self, weights) -> None:
        """Update wfq weights mid-flight (queued work keeps its
        position; future decisions use the new weights)."""
        with self._lock:
            self._sched.set_tenant_weights(weights)

    def sched_snapshot(self) -> Dict[str, Any]:
        """Locked export of the scheduler's per-tenant raw stats."""
        with self._lock:
            return self._sched.snapshot()

    # ---- submission ------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, spec: bool = True,
               deadline: Optional[float] = None,
               tenant: str = sched_lib.DEFAULT_TENANT,
               resume_tokens: Optional[Sequence[int]] = None) -> Request:
        """Queue a request. ``spec=False`` opts it out of speculative
        drafting; ``deadline`` is an absolute wall-clock cutoff;
        ``tenant`` its fair-queueing identity. ``resume_tokens``
        continues a stream whose first tokens were already delivered
        elsewhere: they are pre-seeded into ``output_tokens`` and
        prefilled with the prompt (the recompute-preemption path, so a
        greedy continuation is the uninterrupted run's). Raises
        ValueError for a prompt the cache or the page pool can never
        hold, and :class:`AdmissionError` when the scheduler's queue
        bound is hit."""
        if not prompt_tokens:
            raise ValueError('empty prompt')
        resume = list(map(int, resume_tokens)) if resume_tokens else []
        total = len(prompt_tokens) + len(resume)
        if total > self.ecfg.max_seq_len - 1:
            raise ValueError(
                f'prompt+resume ({total} tokens) exceeds cache capacity '
                f'({self.ecfg.max_seq_len - 1})')
        if self.allocator is not None:
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
        if any(not 0 <= int(t) < vocab
               for t in itertools.chain(prompt_tokens, resume)):
            raise ValueError(f'token ids must lie in [0, {vocab})')
        req = Request(request_id=next(self._ids),
                      prompt_tokens=list(map(int, prompt_tokens)),
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), spec=bool(spec),
                      output_tokens=resume, resumed_from=len(resume),
                      deadline=deadline,
                      tenant=str(tenant) or sched_lib.DEFAULT_TENANT)
        if resume and len(resume) >= req.max_new_tokens:
            # The stream died on its last token: the budget is spent.
            req.finish_reason = 'max_tokens'
            req.finished_at = time.time()
            return req
        try:
            with self._lock:
                # The scheduler's call (global bounds under fcfs/deadline,
                # per-tenant quotas under wfq); the Retry-After estimate
                # divides by the recent emitted tokens per second.
                try:
                    self._sched.admit(req, drain_tps=(
                        self._decode_tokens / self._decode_time
                        if self._decode_time else 0.0))
                except AdmissionError:
                    self._note_anomaly('admission_shed', {
                        'request_id': req.request_id, 'tenant': req.tenant,
                        'prompt_tokens': len(req.prompt_tokens)})
                    raise
                self._sched.enqueue(req)
                if self._sl_on:
                    self._stepline.note_event(
                        req.request_id, req.tenant, 'submit',
                        req.submitted_at,
                        prompt_tokens=len(req.prompt_tokens),
                        **({'resumed_from': req.resumed_from}
                           if req.resumed_from else {}))
        finally:
            # Outside the lock: the dump handoff takes the writer's own
            # condition, which never nests under the engine lock.
            self._flush_stepline_dumps()
        return req

    def cancel(self, req: Request) -> bool:
        """Flag ``req`` cancelled (thread-safe); the engine thread drops
        it at its next step: a queued request never admits, an active
        one finishes 'cancelled' and frees its pages. False when it
        already finished."""
        with self._lock:
            if req.done:
                return False
            req.cancelled = True
        return True

    # ---- KV prefix transfers ---------------------------------------------
    def kv_index_armed(self) -> bool:
        """Whether this engine advertises a fleet prefix index."""
        return self.prefix is not None

    def kv_page_size(self) -> int:
        """KV page size in tokens (the server's export cap needs it); 0
        on the dense cache."""
        return self.allocator.page_size if self.allocator is not None else 0

    def kv_transfer_window(self) -> List[float]:
        """Locked snapshot of the recent KV transfer wall times."""
        with self._lock:
            return list(self._kv_transfer_window)

    def kv_index_snapshot(self, since_gen: int = -1
                          ) -> Optional[Dict[str, Any]]:
        """Wire summary of the radix index for the load balancer's sync
        tick, delta-encoded against ``since_gen``. Built from the step
        loop's published copy, never the live tree. None when the prefix
        cache is off."""
        if self.prefix is None:
            return None
        with self._lock:
            gen, crc, page, journal, hashes = self._kv_index_pub
        return prefix_hash.build_snapshot(gen, crc, page, journal, hashes,
                                          since_gen)

    def request_kv_export(self, tokens: Sequence[int]) -> _KVJob:
        """Queue an export of the cached prefix of ``tokens`` (any
        thread); the stepping thread serializes it at its next step.
        ``job.result`` is the wire blob, or None when nothing is cached.
        The donor's refcounts are never touched."""
        job = _KVJob('export', [int(t) for t in tokens])
        with self._lock:
            self._kv_jobs.append(job)
        return job

    def request_kv_import(self, blob: bytes,
                          fetch_s: float = 0.0) -> _KVJob:
        """Queue the import of a transferred prefix blob (any thread).
        ``fetch_s``, the upstream pull's wall time, folds into the
        duration window so ``kv_transfer_p99_s`` prices the whole pull."""
        job = _KVJob('import', blob, fetch_s=fetch_s)
        with self._lock:
            self._kv_jobs.append(job)
        return job

    def note_kv_transfer_failure(self) -> None:
        """Count a transfer that died before reaching the engine (donor
        fetch error, stall past the budget)."""
        with self._lock:
            self._kv_transfer_failures += 1

    def _service_kv_jobs(self) -> None:
        """Run the queued KV transfer jobs, then republish the index copy,
        on the stepping thread (which owns the tree and the pool). A job
        that fails is counted and handed its error; the step loop goes
        on (the caller recomputes)."""
        with self._lock:
            jobs = list(self._kv_jobs)
            self._kv_jobs.clear()
        for job in jobs:
            t0 = time.perf_counter()
            try:
                result = (self._kv_export(job.payload)
                          if job.kind == 'export'
                          else self._kv_import(job.payload))
            except Exception as exc:  # noqa: BLE001 -- degrade, never crash
                with self._lock:
                    self._kv_transfer_failures += 1
                job.finish(error=exc)
                continue
            if job.kind == 'export' and result is None:
                job.finish(result=None)   # nothing cached: not a transfer
                continue
            dur = time.perf_counter() - t0 + job.fetch_s
            nbytes = len(result) if job.kind == 'export' else len(job.payload)
            with self._lock:
                self._kv_transfers += 1
                self._kv_transfer_bytes += nbytes
                self._kv_transfer_window.append(dur)
            job.finish(result=result)
        if self.prefix is not None:
            pub = self.prefix.publishable()
            with self._lock:
                if pub[0] != self._kv_index_pub[0]:
                    self._kv_index_pub = pub

    def _kv_export(self, tokens: List[int]) -> Optional[bytes]:
        """The cached prefix of ``tokens`` in the int8 wire format (engine
        thread); None when nothing is cached. bf16 pools quantize on
        export with the rules the int8 pages use on write. Read-only: no
        refcount moves, no LRU touch. The host copy synchronizes, so every
        step in flight has run before the pages are read (none writes a
        cached page anyway)."""
        if self.prefix is None:
            raise ValueError('KV export requires the prefix cache')
        pages, matched = self.prefix.peek(tokens)
        if not pages:
            return None
        pids = torch.tensor(pages, dtype=torch.long, device=self.device)
        c = self.cache
        k = c.k_pages.index_select(2, pids).cpu()
        v = c.v_pages.index_select(2, pids).cpu()
        if c.k_scales is not None:
            kq, vq = k.numpy(), v.numpy()
            ks = c.k_scales.index_select(2, pids).cpu().numpy()
            vs = c.v_scales.index_select(2, pids).cpu().numpy()
        else:
            kq, ks = kv_wire.quantize_rows_np(k.float().numpy())
            vq, vs = kv_wire.quantize_rows_np(v.float().numpy())
        return kv_wire.pack(tokens[:matched], self.allocator.page_size,
                            kq, vq, ks, vs)

    def _kv_import(self, blob: bytes) -> int:
        """Decode, verify, write and graft a transferred prefix (engine
        thread). Returns the pages grafted (0 when all were cached here
        already). Raises WireError on anything corrupt, mismatched or
        unsatisfiable; the caller recomputes. The pages are written into
        the pool tensors in place (``index_copy_``), eagerly, after every
        step already dispatched."""
        if self.prefix is None:
            raise ValueError('KV import requires the prefix cache')
        blk = kv_wire.unpack(blob)
        page = self.allocator.page_size
        if blk.page_size != page:
            raise kv_wire.WireError(f'page size {blk.page_size} != local '
                                    f'{page}')
        cfg = self.config
        if (blk.k.shape[0] != cfg.n_layers or blk.k.shape[1] != cfg.n_kv_heads
                or blk.k.shape[4] != cfg.head_dim):
            raise kv_wire.WireError(
                f'KV geometry {blk.k.shape} does not match this model')
        n = blk.n_pages
        if len(blk.tokens) != n * page:
            raise kv_wire.WireError(f'{len(blk.tokens)} tokens do not fill '
                                    f'{n} pages')
        _, have = self.prefix.peek(blk.tokens, whole=True)
        start = have // page
        need = n - start
        if need <= 0:
            return 0
        new = self.allocator.alloc_pages(need)
        if new is None:
            # Page pressure: the same LRU eviction the local attach uses.
            self.prefix.evict(need - self.allocator.free_pages)
            new = self.allocator.alloc_pages(need)
        if new is None:
            raise kv_wire.WireError(f'page pool dry ({need} pages needed)')
        pids = torch.tensor(new, dtype=torch.long, device=self.device)
        c = self.cache

        def put(dst: torch.Tensor, src) -> None:
            dst.index_copy_(2, pids, torch.from_numpy(
                np.ascontiguousarray(src)).to(self.device, dst.dtype))

        if c.k_scales is not None:
            # int8 pool: the transferred bytes land verbatim.
            put(c.k_pages, blk.k[:, :, start:])
            put(c.v_pages, blk.v[:, :, start:])
            put(c.k_scales, blk.k_scales[:, :, start:])
            put(c.v_scales, blk.v_scales[:, :, start:])
        else:
            put(c.k_pages, kv_wire.dequantize_rows_np(
                blk.k[:, :, start:], blk.k_scales[:, :, start:]))
            put(c.v_pages, kv_wire.dequantize_rows_np(
                blk.v[:, :, start:], blk.v_scales[:, :, start:]))
        added = self.prefix.insert_remote(blk.tokens,
                                          [None] * start + list(new))
        if added != need:
            raise AssertionError(f'import diff went stale on the owner '
                                 f'thread: grafted {added} of {need}')
        return added

    # ---- internals -------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise AssertionError(f'prompt length {n} has no bucket (max '
                             f'{self._buckets[-1]})')

    @staticmethod
    def _source_tokens(req: Request) -> List[int]:
        """What prefill must cache: the prompt plus, after a preemption,
        everything already generated (resume by recompute: the final
        chunk's sample is then the next new token)."""
        return req.prompt_tokens + req.output_tokens

    def _host_to_device(self, array: np.ndarray,
                        out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Copy a host array to the device without a host sync: on CUDA
        staged through pinned memory (the caching host allocator keeps
        the block until the copy has run). Into ``out`` in place when
        given."""
        src = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == 'cuda':
            src = src.pin_memory()
        if out is None:
            return src.to(self.device, non_blocking=True)
        out.copy_(src, non_blocking=True)
        return out

    def _do_chunk(self, slot: int) -> Optional[bool]:
        """Advance one prefilling slot by ONE chunk, standalone and with
        no host sync (the sampled token stays on the device; a later
        step's pair carries it). Returns True when the source is fully
        cached (the slot joins this step's decode), False on progress,
        None when the pool cannot cover the chunk right now
        (deferred)."""
        plan = self._prepare_chunk(slot)
        if plan is None:
            return None
        return self._dispatch_chunk_plan(plan)

    def _prepare_chunk(self, slot: int) -> Optional[_ChunkPlan]:
        """The host half of advancing a prefilling slot by one chunk:
        the prefix-cache attach (rolled back if the chunk defers), page
        coverage, bucket, padded tokens; everything but the device call,
        so the chunk can go standalone or ride the decode dispatch. None
        when the pool cannot cover it right now."""
        req = self._slots[slot]
        off = self._prefilling[slot]
        source = self._source_tokens(req)
        just_attached = 0
        prev_cached = req.cached_tokens
        if (self.prefix is not None and off == 0
                and slot not in self._matched
                and self.allocator.pages_of(slot) == 0):
            self._matched.add(slot)
            # First chunk of this residency: attach the longest cached
            # page-aligned prefix and start past it. Attach and dispatch
            # are one host step: if the chunk defers, the attach is rolled
            # back below, so no step ever runs with cached pages in the
            # slot's table while its device length is still 0 (an
            # inactive lane writes its garbage row at table[slot,
            # lengths // page], which must then be the sink).
            pages, matched = self.prefix.match(source)
            if matched:
                self.allocator.attach(slot, pages)
                self._attached_slots.add(slot)
                self._prefilling[slot] = off = matched
                req.cached_tokens = max(req.cached_tokens,
                                        min(matched, len(req.prompt_tokens)))
                just_attached = matched
        n = len(source)
        remaining = n - off
        bucket = self._bucket(min(remaining, self._chunk_cap))
        # A matched offset is page-aligned, not cap-aligned: clamp the
        # bucket so it never runs past the cache end (extend would refuse
        # it forever); the page-sized bucket always fits.
        while off + bucket > self.ecfg.max_seq_len:
            bucket = max(b for b in self._buckets if b < bucket)
        tl = min(remaining, bucket)
        if self.allocator is None:
            table_row = self._dense_rows[slot]
        else:
            ok = self._extend_pages(slot, off + bucket)
            if not ok:
                # Dry by stale accounting: in-flight steps may be about
                # to free pages. Catch up before deferring, so page
                # decisions are the same at every depth.
                self._drain_inflight()
                ok = self._extend_pages(slot, off + bucket)
            if ok:
                # The chunk writes its whole padded bucket: every page of
                # that range must be private before the dispatch.
                ok = self._unshare_write_range(slot, off, off + bucket)
            if not ok:
                if just_attached:
                    # Roll the attach back before deferring (see above);
                    # the retry re-runs the match, so its stats are
                    # uncounted.
                    self.allocator.free(slot)
                    self._attached_slots.discard(slot)
                    self._matched.discard(slot)
                    self._prefilling[slot] = 0
                    req.cached_tokens = prev_cached
                    self.prefix.hits -= 1
                    self.prefix.tokens_saved -= just_attached
                return None
            table_row = self.allocator.table()[slot].copy()
        padded = np.zeros((bucket,), np.int32)
        padded[:tl] = source[off:off + tl]
        return _ChunkPlan(slot=slot, req=req, off=off, bucket=bucket, tl=tl,
                          total=n, padded=padded, table_row=table_row)

    def _note_first_dispatch(self, req: Request) -> None:
        """The queue-wait boundary: the request's first chunk is about
        to dispatch. Not re-stamped on a preemption resume."""
        if req.first_dispatch_at is None:
            req.first_dispatch_at = time.time()
            wait = req.first_dispatch_at - req.submitted_at
            with self._lock:
                self._queue_waits.append(wait)
                self._sched.note_queue_wait(req, wait)
                if self._sl_on:
                    self._stepline.note_event(
                        req.request_id, req.tenant, 'first_dispatch',
                        req.first_dispatch_at, queue_wait_s=round(wait, 6))

    def _stage_chunk(self, plan: _ChunkPlan) -> None:
        """Copy the plan's slot, offset, true length, temperature, table
        row and tokens into the chunk programs' input buffer (one copy,
        no host sync)."""
        maxp = self._table.shape[1]
        staged = np.empty((4 + maxp + plan.bucket,), np.int32)
        staged[:3] = (plan.slot, plan.off, plan.tl)
        staged[3:4] = np.array([plan.req.temperature],
                               np.float32).view(np.int32)
        staged[4:4 + maxp] = plan.table_row
        staged[4 + maxp:] = plan.padded
        self._host_to_device(staged, self._chunk_in[:staged.shape[0]])

    def _chunk_inputs(self, bucket: int):
        """Views of the staged chunk: (slot, offset, true_len as 0-d
        int32 tensors; temperature [1] fp32; table row; tokens)."""
        maxp = self._table.shape[1]
        c = self._chunk_in
        return (c[0], c[1], c[2], c[3:4].view(torch.float32), c[4:4 + maxp],
                c[4 + maxp:4 + maxp + bucket])

    def _chunk_body(self, bucket: int, sampled: bool) -> torch.Tensor:
        """The standalone chunk: the model over the staged chunk, its
        last row's sample into the slot's last token (meaningful on the
        final chunk). Returns the sampled token [1] int32."""
        slot, off, tl, temp, row, tokens = self._chunk_inputs(bucket)
        self.cache, logits = model_lib.paged_prefill_chunk(
            self.config, self.params, self.cache, slot, row, tokens, off, tl,
            self._rope, self._group)
        tok = sampling_lib.sample(logits[None], self._generator, temp,
                                  top_k=self.ecfg.top_k, sampled=sampled)
        self._last.index_put_((slot.long().reshape(1),), tok)
        return tok

    def _dispatch_chunk_plan(self, plan: _ChunkPlan) -> bool:
        """Standalone dispatch of a prepared chunk through the prefill
        program (no host sync). True when the source is fully cached."""
        self._note_first_dispatch(plan.req)
        begin = self._sl_begin()
        self._stage_chunk(plan)
        sampled = plan.req.temperature > 0
        self._sl_start(begin)
        self._run_program(('prefill', plan.bucket, sampled),
                          lambda: self._chunk_body(plan.bucket, sampled))
        self._sl_program(begin, 'prefill', plan.bucket, plan.tl,
                         [(plan.req.request_id, plan.off, plan.tl)],
                         plan.off + plan.tl)
        with self._lock:
            self._prefill_tokens += plan.tl
            self._prefill_chunks += 1
        return self._note_chunk_dispatched(plan)

    def _note_chunk_dispatched(self, plan: _ChunkPlan) -> bool:
        """Advance (or retire) the slot's prefill frontier after its
        chunk went out, standalone or fused. True = fully cached."""
        off = plan.off + plan.tl
        if off < plan.total:
            self._prefilling[plan.slot] = off
            return False
        del self._prefilling[plan.slot]
        self._slot_len[plan.slot] = plan.total
        self._temps[plan.slot] = plan.req.temperature
        self._temps_dirty = True
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

    def _release_slot(self, slot: int, req: Request,  # holds: _lock
                      prefilled_to: Optional[int] = None) -> None:
        """Empty the slot: its pages go to the prefix tree when the cache
        is on (full pages become cached prefixes, the partial tail frees)
        or back to the pool, and its device length goes to 0 (the
        reference's ``_release_slot_pages`` plus ``_free``). Donation
        covers the positions whose K/V the pages hold: ``_slot_len``, or
        ``prefilled_to``, the prefill frontier of a slot released
        mid-prefill (its chunks are dispatched, so in stream order the
        pages hold them before any later step reads them)."""
        self._slots[slot] = None
        self._matched.discard(slot)
        self._attached_slots.discard(slot)
        if self.allocator is None:
            self._slot_len[slot] = 0
            self.cache = cache_lib.free_slot(self.cache, slot)
            return
        if self.prefix is None or not self.allocator.pages_of(slot):
            self.allocator.free(slot)
        else:
            covered = (prefilled_to if prefilled_to is not None
                       else int(self._slot_len[slot]))
            self.prefix.donate(
                (req.prompt_tokens + req.output_tokens)[:covered], slot)
        self._slot_len[slot] = 0
        self.cache = paged_cache_lib.free_slot(self.cache, slot)

    def _note_done(self, req: Request) -> None:  # holds: _lock
        if self._sl_on:
            self._stepline.note_event(
                req.request_id, req.tenant, 'done', req.finished_at,
                finish_reason=req.finish_reason,
                tokens=len(req.output_tokens))

    def _note_first_token(self, req: Request,  # holds: _lock
                          ttft: float) -> None:
        """TTFT is known: the window, the scheduler, the timeline event
        and the TTFT-SLO anomaly trigger."""
        self._ttfts.append(ttft)
        self._sched.note_first_token(req, ttft)
        if not self._sl_on:
            return
        self._stepline.note_event(req.request_id, req.tenant, 'first_token',
                                  req.first_token_at, ttft_s=round(ttft, 6))
        slo = self.ecfg.ttft_slo_s
        if slo is not None and ttft > slo:
            self._note_anomaly('ttft_slo', {
                'request_id': req.request_id, 'tenant': req.tenant,
                'ttft_s': round(ttft, 6), 'slo_s': slo})

    def _finish(self, slot: int, req: Request) -> None:
        with self._lock:
            req.finished_at = time.time()
            if req.first_token_at is None and req.output_tokens:
                req.first_token_at = req.finished_at
                self._note_first_token(req,
                                       req.finished_at - req.submitted_at)
            self._note_done(req)
            if req.finish_reason == 'cache_full':
                self._note_anomaly('cache_full', {
                    'request_id': req.request_id, 'tenant': req.tenant,
                    'slot': slot})
            self._prefilling.pop(slot, None)
            self._release_slot(slot, req)
        req._notify()

    def _finish_queued(self, req: Request, reason: str) -> None:
        """Finish a request that never reached a slot (abandoned or
        expired while waiting). Under the engine lock."""
        req.finish_reason = reason
        req.finished_at = time.time()
        self._note_done(req)
        req._notify()

    def _finish_early(self, slot: int, req: Request, reason: str) -> None:
        """Tear an active slot down outside the natural finish path
        (client gone, deadline passed), mid-prefill included. In-flight
        steps for the slot drop their tokens by the stale-by-one rule."""
        with self._lock:
            prefilled_to = self._prefilling.pop(slot, None)
            req.finish_reason = reason
            req.finished_at = time.time()
            self._note_done(req)
            self._release_slot(slot, req, prefilled_to)
        req._notify()

    def _sweep_dead_requests(self) -> None:  # holds: _lock
        """Drop queued requests whose client is gone or whose deadline
        passed, and finish active ones ('cancelled' / 'deadline')."""
        if not self.wallclock_cancel:
            return
        now = time.time()
        for r, reason in self._sched.sweep(now):
            if reason == 'cancelled':
                self._abandoned += 1
            else:
                self._expired += 1
            self._finish_queued(r, reason)
        for slot, r in enumerate(self._slots):
            if r is None:
                continue
            if r.cancelled:
                self._cancelled += 1
                self._sched.note_outcome(r, 'cancelled')
                self._finish_early(slot, r, 'cancelled')
            elif r.deadline is not None and now > r.deadline:
                self._expired += 1
                self._sched.note_outcome(r, 'deadline')
                self._finish_early(slot, r, 'deadline')

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` to reclaim its pages: the request goes back to
        the FRONT of the queue and resumes by recomputing prompt +
        generated tokens (with the prefix cache its donated pages make the
        resume re-match its own prefix, so the recompute shrinks to the
        partial tail). Streamed output is kept; TTFT is not
        re-recorded."""
        with self._lock:
            req = self._slots[slot]
            prefilled_to = self._prefilling.pop(slot, None)
            self._release_slot(slot, req, prefilled_to)
            self._sched.requeue(req)
            self._preemptions += 1
            self._note_anomaly('preemption', {
                'request_id': req.request_id, 'tenant': req.tenant,
                'slot': slot,
                'tokens_recomputed': len(req.prompt_tokens)
                + len(req.output_tokens)})

    def _unshare_write_range(self, slot: int, start_tok: int,
                             end_tok: int) -> bool:
        """Copy-on-write every shared page the coming writes to positions
        [start_tok, end_tok) would touch, so no dispatch ever mutates a
        page the tree (or another slot) still maps. False when a copy
        could not get a page (pool dry, nothing evictable): the caller
        treats that like a failed ``extend``. Under the current match
        policy no copy fires (a match stops strictly before the prompt's
        last token, so attached pages sit behind the write frontier); the
        invariant is enforced here all the same. The copy is an eager
        in-place write of the pool, ordered on the stream after every
        step already dispatched."""
        if self.prefix is None or slot not in self._attached_slots:
            # Only a slot that attached cached pages can map a shared
            # page: fresh pages are born at refcount 1.
            return True
        al = self.allocator
        page = al.page_size
        first = start_tok // page
        last = (max(end_tok, start_tok + 1) - 1) // page
        for idx in range(first, min(last + 1, al.pages_of(slot))):
            if al.refcount(al.page_at(slot, idx)) <= 1:
                continue
            if not al.free_pages:
                self.prefix.evict(1)
            pair = al.cow(slot, idx)
            if pair is None:
                return False
            paged_cache_lib.copy_page(self.cache, *pair)
        return True

    def _extend_pages(self, slot: int, upto_tokens: int) -> bool:
        """``allocator.extend`` with the prefix cache's LRU evictor as the
        pressure valve: reclaim unreferenced cached pages (leaf first)
        only when the free stack cannot cover the growth, and only as
        many as the shortfall, before the caller drains or preempts."""
        if self.allocator.extend(slot, upto_tokens):
            return True
        if self.prefix is None:
            return False
        need = self.allocator.pages_needed(upto_tokens)
        if need > self.allocator.max_pages_per_slot:
            return False   # the per-slot ceiling: eviction cannot help
        shortfall = (need - self.allocator.pages_of(slot)
                     - self.allocator.free_pages)
        if shortfall <= 0 or not self.prefix.evict(shortfall):
            return False
        return self.allocator.extend(slot, upto_tokens)

    def _ensure_decode_pages(self, decoding: List[int]) -> List[int]:
        """Every decoding slot must own the page its next token writes,
        counting the tokens still in flight (slot_len + in-flight + 1).
        Where the pool is dry: drain the in-flight steps, then preempt
        the scheduler's victim, then finish 'cache_full' (the slot
        outgrew its ceiling or is alone); with the prefix cache, unreferenced
        cached pages are evicted before any of that. Decisions follow a
        drain only,
        so they are the same at every depth. Returns the slots still
        decoding."""
        decoding = list(decoding)

        def target(s: int) -> int:
            return int(self._slot_len[s]) + self._inflight_tok[s] + 1

        for slot in list(decoding):
            if slot not in decoding:
                continue   # preempted as an earlier slot's victim
            if self._slots[slot] is None:
                decoding.remove(slot)
                continue
            # The unshare runs once coverage exists; its failure (a shared
            # page the pool cannot copy) walks the same ladder as a dry
            # pool.
            while not (self._extend_pages(slot, target(slot))
                       and self._unshare_write_range(
                           slot, int(self._slot_len[slot]),
                           target(slot))):
                if self._queue:
                    self._drain_inflight()
                    if self._slots[slot] is None:
                        break
                    continue
                if (self.allocator.pages_needed(target(slot))
                        > self.allocator.max_pages_per_slot):
                    req = self._slots[slot]
                    req.finish_reason = 'cache_full'
                    self._finish(slot, req)
                    break
                victims = [s for s, r in enumerate(self._slots)
                           if r is not None and s != slot]
                if not victims:
                    req = self._slots[slot]
                    req.finish_reason = 'cache_full'
                    self._finish(slot, req)
                    break
                with self._lock:
                    victim = self._sched.pick_victim(victims, self._slots)
                self._preempt(victim)
                if victim in decoding:
                    decoding.remove(victim)
        return [s for s in decoding
                if self._slots[s] is not None
                and s not in self._prefilling]

    # ---- the step --------------------------------------------------------
    def step(self) -> int:
        """Refill free slots from the scheduler, advance prefill (at most
        ``prefill_chunks_per_step`` standalone chunks, the scheduler
        picking which; with ``fused_prefill`` and a decode batch, one
        chunk that rides the decode dispatch instead), then dispatch one
        decode, verify or mixed step for every fully prefilled slot, and
        read back steps until at most ``pipeline_depth`` remain in
        flight. Returns the number of slots worked on.

        With the flight recorder on, the step runs between a counter
        snapshot and a ring append derived from clocks and counter
        deltas only, so a recorded step is the unrecorded one."""
        with torch.no_grad():
            if not self._sl_on:
                return self._step()
            t0 = time.perf_counter()
            t_wall = time.time()
            self._sl_t0 = t0
            self._sl_stages = []
            self._sl_programs = self._sl_batch = 0
            with self._lock:
                pre = (self._prefill_tokens, self._spec_drafted,
                       self._spec_accepted, self._decode_steps,
                       self._spec_steps, self._fused_steps,
                       self._decode_tokens)
            try:
                worked = self._step()
                if not worked and not self._sl_programs:
                    self._sl_prev_end = None   # an idle tick
                self._sl_record(t_wall, time.perf_counter() - t0, pre)
            finally:
                self._sl_stages = None
            self._flush_stepline_dumps()
            return worked

    def _step(self) -> int:
        self._service_kv_jobs()
        t_s = time.perf_counter()
        with self._lock:
            self._sweep_dead_requests()
            spec_k = self._spec_k
            for slot in range(self.ecfg.n_slots):
                if self._slots[slot] is None:
                    req = self._sched.pop_next()
                    if req is None:
                        break
                    self._slots[slot] = req
                    self._prefilling[slot] = 0
                    self._matched.discard(slot)
                    if self._sl_on and req.first_dispatch_at is not None:
                        # Back in a slot after a dispatch: a preemption
                        # resume.
                        self._stepline.note_event(
                            req.request_id, req.tenant, 'resume',
                            time.time(), slot=slot)
        self._sl_stage('schedule', t_s)
        just_prefilled: List[int] = []
        deferred: set = set()
        plan: Optional[_ChunkPlan] = None
        has_decode = any(r is not None and s not in self._prefilling
                         for s, r in enumerate(self._slots))
        if self._fused and has_decode and self._prefilling:
            # One chunk rides the decode dispatch; the scheduler picks
            # the slot. A dry pool defers it while decode goes on.
            t_s = time.perf_counter()
            with self._lock:
                slot = self._sched.next_prefill_slot(
                    sorted(self._prefilling), self._slots)
            self._sl_stage('schedule', t_s)
            plan = self._prepare_chunk(slot)
        else:
            dispatched = 0
            for _ in range(self.ecfg.prefill_chunks_per_step):
                candidates = sorted(s for s in self._prefilling
                                    if s not in deferred)
                if not candidates:
                    break
                t_s = time.perf_counter()
                with self._lock:
                    slot = self._sched.next_prefill_slot(candidates,
                                                         self._slots)
                self._sl_stage('schedule', t_s)
                result = self._do_chunk(slot)
                if result is None:
                    deferred.add(slot)
                else:
                    dispatched += 1
                    if result:
                        just_prefilled.append(slot)
            if dispatched and has_decode:
                # Decoding slots waited on standalone chunks this step.
                with self._lock:
                    self._stall_steps += 1
        if deferred and not any(r is not None and s not in self._prefilling
                                for s, r in enumerate(self._slots)):
            # Nothing decodes, so nothing will free pages: the
            # scheduler's victim among the other page-holding slots gives
            # way to the oldest deferred one, or the deferred request
            # alone has outgrown the pool.
            keep = min(deferred, key=lambda s: self._slots[s].submitted_at)
            victims = [s for s, r in enumerate(self._slots)
                       if r is not None and s != keep
                       and self.allocator.pages_of(s) > 0]
            if victims:
                with self._lock:
                    victim = self._sched.pick_victim(victims, self._slots)
                self._preempt(victim)
            else:
                req = self._slots[keep]
                req.finish_reason = 'cache_full'
                self._finish(keep, req)
        if plan is not None:
            # The mixed step has no draft lanes: speculation stands down
            # for this step (outputs are the same; step counts move).
            spec_k = 0
        if spec_k:
            # Drafting continues the host-known tokens, which an
            # in-flight step is about to extend: catch up first, unless
            # no slot could draft (then keep the overlap).
            fresh = set(just_prefilled)
            eligible = [s for s in range(self.ecfg.n_slots)
                        if self._spec_eligible(s, fresh)]
            if not eligible:
                spec_k = 0
            elif self._queue and not any(
                    self._drafter.propose(
                        drafter_lib.cached_context(
                            self._slots[s].prompt_tokens,
                            self._slots[s].output_tokens,
                            self._slots[s].draft_memo),
                        1, memo=self._slots[s].draft_memo)
                    for s in eligible):
                spec_k = 0
        if spec_k and self._queue:
            t0 = time.perf_counter()
            self._drain_inflight()
            with self._lock:
                self._decode_time += time.perf_counter() - t0
        decoding = [s for s, r in enumerate(self._slots)
                    if r is not None and s not in self._prefilling]
        if self.allocator is not None and decoding:
            decoding = self._ensure_decode_pages(decoding)
        if plan is not None and (
                self._slots[plan.slot] is not plan.req
                or self._prefilling.get(plan.slot) != plan.off):
            # The chunk's slot was preempted while decode page pressure
            # resolved: it re-prefills from the queue.
            plan = None
        if not decoding and not self._queue and plan is None:
            return len(self._prefilling)
        t0 = time.perf_counter()
        if plan is not None:
            if decoding:
                self._dispatch_mixed(decoding, plan)
            elif self._dispatch_chunk_plan(plan):
                # The decode batch evaporated: the chunk went standalone,
                # and a completed prompt's first token surfaces through
                # the next dispatch's pair.
                self._pending_first[plan.slot] = plan.req
        elif decoding:
            # No drafts this step (speculation off, no eligible slot, or
            # no n-gram matched): the plain decode step is the cheaper.
            drafts = (self._build_drafts(decoding, just_prefilled, spec_k)
                      if spec_k else None)
            if drafts is not None:
                self._dispatch_verify(decoding, just_prefilled, *drafts)
            else:
                self._dispatch_decode(decoding, just_prefilled)
        # At most _depth steps stay in flight; with nothing dispatched
        # there is no overlap to win, so drain (finished requests
        # surface and idle() can flip).
        allowed = self._depth if decoding else 0
        while len(self._queue) > allowed:
            self._consume_one()
        with self._lock:
            self._decode_time += time.perf_counter() - t0
        return len(decoding) + len(self._prefilling)

    def _refresh_dispatch_state(self, decoding: List[int]) -> bool:
        """Copy the block table, the active mask and the temperatures
        into their static device buffers where they changed. Returns
        whether any decoding slot samples (it selects the program)."""
        if (self.allocator is not None
                and self._table_version != self.allocator.version):
            self._host_to_device(self.allocator.table(), self._table)
            self._table_version = self.allocator.version
        key = tuple(decoding)
        if key != self._active_key:
            mask = np.zeros((self.ecfg.n_slots,), np.bool_)
            mask[decoding] = True
            self._host_to_device(mask, self._active)
            self._active_key = key
        if self._temps_dirty:
            self._host_to_device(self._temps, self._temps_dev)
            self._temps_dirty = False
        return bool((self._temps[decoding] > 0).any())

    def _run_program(self, key: tuple, body: Callable[[], torch.Tensor]
                     ) -> torch.Tensor:
        """Run the step program ``key`` = (kind, queries per slot or chunk
        bucket, samples) and return its output on the device. Eager where
        graphs are off. On the card: the first run goes eagerly on the
        capture stream (it builds what the step needs: kernels, cuBLAS
        handles, workspaces), the second captures a CUDA graph, and
        every run from then on replays it."""
        prog = self._programs.setdefault(key, _StepProgram())
        prog.runs += 1
        if not self._graphs_on:
            return body()
        if prog.graph is None:
            stream = self._capture_stream
            current = torch.cuda.current_stream(self.device)
            if prog.runs == 1:
                stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    out = body()
                current.wait_stream(stream)
                out.record_stream(current)
                return out
            graph = torch.cuda.CUDAGraph()
            if key[2]:
                # The sampled program draws from the engine's generator:
                # each replay must advance it.
                graph.register_generator_state(self._generator)
            before = _captured_launches()
            # A CUDA graph destroyed while this one captures (an engine
            # dropped earlier, freed by the cyclic garbage collector)
            # invalidates the capture: collect now, and hold the
            # collector off until the capture ends.
            collecting = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=stream):
                    out = body()
            except Exception as e:
                raise RuntimeError(
                    f'CUDA graph capture of the {key[0]} step '
                    f'({"bucket" if key[0] in ("prefill", "mixed") else "R"}'
                    f'={key[1]}, sampled={key[2]}) failed; no eager '
                    f'fallback') from e
            finally:
                if collecting:
                    gc.enable()
            prog.graph, prog.out = graph, out
            now = _captured_launches()
            prog.launches = {k: now[k] - before[k] for k in before
                             if now[k] != before[k]}
        prog.graph.replay()
        paged_attn.count_replay({k: n for k, n in prog.launches.items()
                                 if k in paged_attn.launches})
        quant_lib.count_replay({k: n for k, n in prog.launches.items()
                                if k in quant_lib.launches})
        return prog.out

    @staticmethod
    def _finite_row(logits: torch.Tensor) -> torch.Tensor:
        """The SDC sentinel row: per slot, whether every logit of the
        step (every candidate's, on verify) is finite, as int32."""
        return torch.isfinite(logits).flatten(1).all(dim=1).to(torch.int32)

    def _decode_body(self, sampled: bool) -> torch.Tensor:
        """The decode step over every slot: [2, slots] int32, row 0 the
        input tokens (the first token of each slot that finished prefill
        this step), row 1 the new tokens, plus the sentinel row last; the
        new tokens become the next input."""
        logits, self.cache = model_lib.paged_decode_step(
            self.config, self.params, self.cache, self._table, self._last,
            self._rope, self._active, self._group)
        toks = sampling_lib.sample(logits, self._generator, self._temps_dev,
                                   top_k=self.ecfg.top_k, sampled=sampled)
        toks_out = torch.where(self._active, toks, self._last)
        rows = [self._last, toks_out]
        if self._sentinel:
            rows.append(self._finite_row(logits))
        pair = torch.stack(rows)
        self._last.copy_(toks_out)
        return pair

    def _mixed_body(self, bucket: int, sampled: bool) -> torch.Tensor:
        """The staged chunk and the decode step in one program: the
        chunk's sample lands in its slot's last token, the decode half
        samples every active slot. [2, slots] int32: row 0 the last-token
        vector after the chunk (so a completing chunk's first token comes
        back in the same read), row 1 the new tokens, plus the sentinel
        row, whose chunk-slot flag also covers the chunk's logits."""
        slot, off, tl, temp, row, tokens = self._chunk_inputs(bucket)
        chunk_logits, dec_logits, self.cache = model_lib.paged_mixed_step(
            self.config, self.params, self.cache, slot, row, tokens, off, tl,
            self._table, self._last, self._rope, self._active, self._group)
        first = sampling_lib.sample(chunk_logits[None], self._generator,
                                    temp, top_k=self.ecfg.top_k,
                                    sampled=sampled)
        index = (slot.long().reshape(1),)
        last1 = self._last.index_put(index, first)
        toks = sampling_lib.sample(dec_logits, self._generator,
                                   self._temps_dev, top_k=self.ecfg.top_k,
                                   sampled=sampled)
        toks_out = torch.where(self._active, toks, last1)
        rows = [last1, toks_out]
        if self._sentinel:
            flags = self._finite_row(dec_logits)
            chunk_ok = torch.isfinite(chunk_logits).all().to(torch.int32)
            rows.append(flags.index_put(index, flags[index] * chunk_ok))
        pair = torch.stack(rows)
        self._last.copy_(toks_out)
        return pair

    def _verify_body(self, r: int, sampled: bool) -> torch.Tensor:
        """The verify step over every slot: the run's K/V writes, every
        candidate's logits, exact-greedy acceptance and the device-side
        advance (lengths += accepted + 1 on active slots, the corrected
        token becomes the next input). [r + 2, slots] int32: row 0 the
        input tokens, rows 1..r the model's token at each position, row
        r + 1 the accepted count, then the sentinel row."""
        drafts = self._drafts[r]
        tokens = torch.cat([self._last[:, None], drafts], dim=1)
        logits, self.cache = model_lib.paged_verify_step(
            self.config, self.params, self.cache, self._table, tokens,
            self._rope, self._group)
        emitted, accepted = sampling_lib.speculative_accept(
            logits, drafts, self._draft_lens, self._generator,
            self._temps_dev, top_k=self.ecfg.top_k, sampled=sampled)
        active = self._active
        accepted = torch.where(active, accepted, torch.zeros_like(accepted))
        next_tok = emitted.gather(1, accepted.long()[:, None])[:, 0]
        lengths = self.cache.lengths
        lengths += (accepted + 1).to(lengths.dtype) * active.to(lengths.dtype)
        rows = [tokens[:, :1].T, emitted.T, accepted[None]]
        if self._sentinel:
            rows.append(self._finite_row(logits)[None])
        pair = torch.cat(rows, dim=0)
        self._last.copy_(torch.where(active, next_tok, tokens[:, 0]))
        return pair

    def _enqueue_readback(self, pair: torch.Tensor, decoded, prefilled,
                          spec_r: Optional[int]
                          ) -> Optional[torch.cuda.Event]:
        """Start the pair's copy into the next host ring buffer (pinned
        on CUDA, the copy asynchronous on the step's stream, so the next
        replay cannot overwrite the pair first), record an event after
        it (returned), and queue the step for consumption. The ring is
        rebuilt when the depth changes or a pair outgrows it (room for a
        verify pair of the current width); steps in flight keep their own
        buffers."""
        if (len(self._ring) != self._depth + 1
                or self._ring[0].shape[0] < pair.shape[0]):
            pin = self.device.type == 'cuda'
            rows = max(pair.shape[0], self._spec_k + 3 + self._sentinel)
            self._ring = [torch.empty((rows, self.ecfg.n_slots),
                                      dtype=torch.int32, pin_memory=pin)
                          for _ in range(self._depth + 1)]
            self._ring_i = 0
        host = self._ring[self._ring_i][:pair.shape[0]]
        self._ring_i = (self._ring_i + 1) % len(self._ring)
        host.copy_(pair, non_blocking=True)
        event = None
        if self.device.type == 'cuda':
            # Timed with the recorder on: it ends the program's record.
            event = torch.cuda.Event(enable_timing=self._sl_on)
            event.record()
        self._queue.append((host, event, decoded, prefilled, spec_r))
        return event

    def _take_pending_first(self) -> List[tuple]:
        """The slots whose first token waits in _last since a standalone
        chunk completed them (fused mode), for this dispatch's pair row
        0; a slot refilled or preempted since re-prefills instead."""
        if not self._pending_first:
            return []
        out = [(s, r) for s, r in self._pending_first.items()
               if self._slots[s] is r]
        self._pending_first.clear()
        return out

    def _dispatch_decode(self, decoding: List[int],
                         just_prefilled: List[int]) -> None:
        """Dispatch one decode step (no host sync)."""
        begin = self._sl_begin()
        kv = self._kv_read(decoding, 1) if begin else 0
        sampled = self._refresh_dispatch_state(decoding)
        self._sl_start(begin)
        pair = self._run_program(('decode', 1, sampled),
                                 lambda: self._decode_body(sampled))
        with self._lock:
            self._decode_steps += 1
            for s in decoding:
                self._inflight_tok[s] += 1
        end = self._enqueue_readback(
            pair, [(s, self._slots[s]) for s in decoding],
            self._take_pending_first()
            + [(s, self._slots[s]) for s in just_prefilled], None)
        self._sl_program(begin, 'decode', 1, len(decoding), [], kv, end)

    def _dispatch_mixed(self, decoding: List[int], plan: _ChunkPlan) -> None:
        """Dispatch ONE mixed step (no host sync): the plan's chunk and
        the decode batch in one program. Its pair rides the in-flight
        queue like a decode pair; a chunk that completes its prompt
        surfaces its first token through row 0 and joins the next step's
        decode (one step later than unfused, the same tokens)."""
        begin = self._sl_begin()
        kv = (self._kv_read(decoding, 1) + plan.off + plan.tl
              if begin else 0)
        sampled = self._refresh_dispatch_state(decoding)
        sampled = sampled or plan.req.temperature > 0
        self._note_first_dispatch(plan.req)
        self._stage_chunk(plan)
        self._sl_start(begin)
        pair = self._run_program(
            ('mixed', plan.bucket, sampled),
            lambda: self._mixed_body(plan.bucket, sampled))
        with self._lock:
            self._decode_steps += 1
            self._fused_steps += 1
            self._prefill_tokens += plan.tl
            self._prefill_chunks += 1
            for s in decoding:
                self._inflight_tok[s] += 1
        completes = self._note_chunk_dispatched(plan)
        prefilled = self._take_pending_first()
        if completes:
            prefilled.append((plan.slot, plan.req))
        end = self._enqueue_readback(
            pair, [(s, self._slots[s]) for s in decoding], prefilled, None)
        self._sl_program(begin, 'mixed', plan.bucket, len(decoding),
                         [(plan.req.request_id, plan.off, plan.tl)], kv, end)

    # ---- speculative decoding -------------------------------------------
    def _spec_eligible(self, s: int, fresh: set) -> bool:
        """May slot ``s`` draft this step? Greedy, opted in, fully
        prefilled, and not one of this step's fresh prefills (their first
        token is still on the device, so the host cannot continue the
        sequence)."""
        r = self._slots[s]
        return (r is not None and s not in self._prefilling
                and s not in fresh and r.temperature == 0 and r.spec)

    def _build_drafts(self, decoding: List[int], just_prefilled: List[int],
                      spec_k: int) -> Optional[tuple]:
        """Prompt-lookup drafts for this step's decoding slots:
        ``(draft_mat [slots, spec_k], draft_lens [slots])`` int32,
        zero-padded, or None when nobody drafted. A slot's width is the
        scheduler's ``spec_budget``, cut so every drafted position and
        the corrected token fit in the cache and no token past the
        request's budget is drafted; a pool that cannot cover the run
        trims the draft, never the workload, and every page the run
        writes is made private first (copy-on-write)."""
        lens = np.zeros((self.ecfg.n_slots,), np.int32)
        mat = np.zeros((self.ecfg.n_slots, spec_k), np.int32)
        fresh = set(just_prefilled)
        eligible = [s for s in decoding if self._spec_eligible(s, fresh)]
        if not eligible:
            return None
        with self._lock:
            budgets = {s: self._sched.spec_budget(self._slots[s], spec_k)
                       for s in eligible}
        any_draft = False
        for s in eligible:
            req = self._slots[s]
            base = int(self._slot_len[s])
            budget = min(int(budgets[s]), spec_k,
                         self.ecfg.max_seq_len - 2 - base,
                         req.max_new_tokens - len(req.output_tokens) - 1)
            if budget <= 0:
                continue
            prop = self._drafter.propose(
                drafter_lib.cached_context(req.prompt_tokens,
                                           req.output_tokens,
                                           req.draft_memo),
                budget, memo=req.draft_memo)
            if prop and self.allocator is not None and not \
                    self.allocator.extend(s, base + len(prop) + 1):
                covered = (self.allocator.pages_of(s)
                           * self.allocator.page_size)
                prop = prop[:max(0, covered - base - 1)]
            if prop and not self._unshare_write_range(
                    s, base, base + len(prop) + 1):
                # The run writes [base, base + len + 1): a shared page
                # there that cannot be copied drops the draft.
                prop = []
            if not prop:
                continue
            lens[s] = len(prop)
            mat[s, :len(prop)] = prop
            any_draft = True
        return (mat, lens) if any_draft else None

    def _dispatch_verify(self, decoding: List[int],
                         just_prefilled: List[int],
                         draft_mat: np.ndarray,
                         draft_lens: np.ndarray) -> None:
        """Dispatch one verify step (no host sync); its pair rides the
        in-flight queue like a decode pair."""
        begin = self._sl_begin()
        r = draft_mat.shape[1] + 1
        kv = self._kv_read(decoding, r) if begin else 0
        sampled = self._refresh_dispatch_state(decoding)
        if r not in self._drafts:
            self._drafts[r] = torch.zeros((self.ecfg.n_slots, r - 1),
                                          dtype=torch.int32,
                                          device=self.device)
        self._host_to_device(draft_mat, self._drafts[r])
        self._host_to_device(draft_lens, self._draft_lens)
        self._sl_start(begin)
        pair = self._run_program(('verify', r, sampled),
                                 lambda: self._verify_body(r, sampled))
        with self._lock:
            self._decode_steps += 1
            self._spec_steps += 1
            for s in decoding:
                self._inflight_tok[s] += int(draft_lens[s]) + 1
        end = self._enqueue_readback(
            pair, [(s, self._slots[s], int(draft_lens[s])) for s in decoding],
            self._take_pending_first()
            + [(s, self._slots[s]) for s in just_prefilled], r)
        self._sl_program(begin, 'verify', r, len(decoding), [], kv, end)

    # ---- host bookkeeping ------------------------------------------------
    def _consume_one(self) -> None:
        """Read back the OLDEST in-flight step (waiting on its event
        alone) and apply it: first tokens of the slots that finished
        prefill at its dispatch (row 0), then each decoding slot's new
        token (row 1), or its accepted run on a verify step. Stale-by-one:
        a slot that no longer holds the request it held at dispatch
        (finished or preempted since) drops its token. With the sentinel,
        a slot whose flag (the pair's last row) is 0 finishes 'sdc'
        instead of taking its token."""
        host, event, decoded, prefilled, spec_r = self._queue.popleft()
        t_rb = time.perf_counter()
        if event is not None:
            event.synchronize()
        pair = host.numpy().copy()
        t_bk = self._sl_stage('readback', t_rb)
        now = time.time()
        bad = (set(np.flatnonzero(pair[-1] == 0).tolist())
               if self._sentinel else set())
        touched: List[Request] = []
        with self._lock:
            if self._sl_pending:
                self._sl_complete(event)
            for slot, req in prefilled:
                if req is None or req.done or self._slots[slot] is not req:
                    continue
                if slot in bad:
                    self._sdc_hit(slot, req)
                    continue
                first = int(pair[0, slot])
                if req.first_token_at is None:
                    req.first_token_at = now
                    self._note_first_token(req, now - req.submitted_at)
                req.output_tokens.append(first)
                self._decode_tokens += 1
                self._sched.note_tokens(req)
                touched.append(req)
                if self._finished(req, slot, first):
                    # The token decoded this same step dies with the slot.
                    self._finish(slot, req)
            if spec_r is not None:
                self._consume_verify(pair, decoded, spec_r, touched, bad)
                decoded = ()
            for slot, req in decoded:
                self._inflight_tok[slot] = max(
                    0, self._inflight_tok[slot] - 1)
                if req is None or req.done or self._slots[slot] is not req:
                    continue
                if slot in bad:
                    self._sdc_hit(slot, req)
                    continue
                token = int(pair[1, slot])
                req.output_tokens.append(token)
                self._slot_len[slot] += 1
                self._decode_tokens += 1
                self._sched.note_tokens(req)
                touched.append(req)
                if self._finished(req, slot, token):
                    self._finish(slot, req)
        for req in touched:
            if not req.done:
                req._notify()
        self._sl_stage('drain', t_bk)

    def _consume_verify(self, pair: np.ndarray, decoded, spec_r: int,
                        touched: List[Request],
                        bad=frozenset()) -> None:  # holds: _lock
        """Emit each slot's accepted run plus the corrected token ONE
        token at a time through the same finish ladder as plain decode
        (eos / max_tokens / cache_full fire mid-run and drop the tail,
        just what speculation-off would have produced), then roll the
        pages extended for rejected drafts back to the pool. ``decoded``
        rows are (slot, request, draft_len); the accepted count sits in
        row ``spec_r + 1``."""
        for slot, req, dl in decoded:
            self._inflight_tok[slot] = max(
                0, self._inflight_tok[slot] - (dl + 1))
            if req is None or req.done or self._slots[slot] is not req:
                continue
            if slot in bad:
                self._sdc_hit(slot, req)
                continue
            accepted = min(int(pair[spec_r + 1, slot]), dl)
            if dl > 0:
                # Only drafting lanes feed the speculation counters: a
                # draft_len 0 lane emits one token like plain decode.
                self._spec_slot_steps += 1
                self._spec_drafted += dl
                self._spec_accepted += accepted
                req.spec_steps += 1
            for i in range(accepted + 1):
                token = int(pair[1 + i, slot])
                req.output_tokens.append(token)
                self._slot_len[slot] += 1
                self._decode_tokens += 1
                if dl > 0:
                    self._spec_emitted += 1
                    req.spec_emitted += 1
                self._sched.note_tokens(req)
                if self._finished(req, slot, token):
                    self._finish(slot, req)
                    break
            if req.done:
                continue
            touched.append(req)
            if self.allocator is not None:
                # Pages extended past the new frontier (the next token's
                # write page is kept) return to the pool now.
                self.allocator.shrink(slot, int(self._slot_len[slot]) + 1)

    def _sdc_hit(self, slot: int, req: Request) -> None:  # holds: _lock
        """Non-finite logits for a live slot: its token is dropped, the
        request finishes 'sdc', the engine turns integrity_suspect (for
        good: the server's /health answers 503 "corrupt" and /generate
        refuses) and an 'sdc' anomaly dump snapshots the recorder."""
        self._sdc_events += 1
        self._integrity_suspect = True
        self._note_anomaly('sdc', {'slot': slot,
                                   'request_id': req.request_id,
                                   'tenant': req.tenant})
        self._finish_early(slot, req, 'sdc')

    def integrity_suspect(self) -> bool:
        """The one-way corruption verdict (read lock-free: a bool, one
        stale step tolerated)."""
        return self._integrity_suspect

    def output_digest(self) -> int:
        """A stable CRC over each active slot's (request id, output
        tokens), slot-ordered (zlib.crc32, never the salted builtin
        hash), as the reference's."""
        with self._lock:
            parts = [f'{slot}:{req.request_id}:'
                     f'{",".join(map(str, req.output_tokens))}'
                     for slot, req in enumerate(self._slots)
                     if req is not None]
        return zlib.crc32(';'.join(parts).encode())

    def _drain_inflight(self) -> None:
        """Consume every in-flight step (host state catches up with the
        device): before page-pressure decisions and drafting."""
        while self._queue:
            self._consume_one()

    # ---- driving ---------------------------------------------------------
    def idle(self) -> bool:
        with self._lock:
            return (not self._sched.pending()
                    and all(r is None for r in self._slots)
                    and not self._queue)

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if self.idle():
                return
            self.step()

    @property
    def graphs_on(self) -> bool:
        """Whether the step programs run as CUDA graphs."""
        return self._graphs_on

    def warm_programs(self) -> List[tuple]:
        """Run every greedy step program twice on an idle engine, so that
        on the card each is built, then captured, and a live request only
        replays graphs: the chunk program of each bucket, decode, verify
        at spec_k + 1 queries (speculation on) and the mixed program of
        each bucket (fused on). No slot is active and the chunk is slot
        0's at offset 0, so every K/V write lands where no live request
        reads (the dense cache: slot 0's first rows and each slot's
        frontier row, which a request's prefill overwrites first; the
        paged cache: the sink page); the cache lengths and last tokens
        return to 0 after. Returns the keys run."""
        if not self.idle():
            raise RuntimeError('warm_programs needs an idle engine')
        self._refresh_dispatch_state([])
        maxp = self._table.shape[1]
        row = (self._dense_rows[0] if self.allocator is None
               else np.zeros((maxp,), np.int32))   # the sink page

        def stage(bucket: int) -> None:
            staged = np.zeros((4 + maxp + bucket,), np.int32)
            staged[2] = bucket
            staged[4:4 + maxp] = row
            self._host_to_device(staged, self._chunk_in[:staged.shape[0]])

        programs: List[Tuple[tuple, Callable[[], torch.Tensor]]] = []
        for b in self._buckets:
            programs.append((('prefill', b, False),
                             lambda b=b: self._chunk_body(b, False)))
        programs.append((('decode', 1, False),
                         lambda: self._decode_body(False)))
        r = self._spec_k + 1
        if r > 1:
            if r not in self._drafts:
                self._drafts[r] = torch.zeros((self.ecfg.n_slots, r - 1),
                                              dtype=torch.int32,
                                              device=self.device)
            self._draft_lens.zero_()
            programs.append((('verify', r, False),
                             lambda: self._verify_body(r, False)))
        if self._fused:
            for b in self._buckets:
                programs.append((('mixed', b, False),
                                 lambda b=b: self._mixed_body(b, False)))
        for key, body in programs:
            for _ in range(2):
                if key[0] in ('prefill', 'mixed'):
                    stage(key[1])
                self._run_program(key, body)
        self.cache.lengths.zero_()
        self._last.zero_()
        return [key for key, _ in programs]

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0) -> List[Request]:
        """Batch convenience: submit all, run to completion."""
        reqs = [self.submit(p, max_new_tokens, temperature)
                for p in prompts]
        self.run_until_idle()
        return reqs

    # ---- flight recorder -------------------------------------------------
    def note_lifecycle_event(self, event: str, t: Optional[float] = None,
                             **detail: Any) -> None:
        """Stamp a replica-lifecycle milestone (weights loaded, warm)
        into the event ring, beside the request timelines on the same
        clock. Request id -1 keys this pseudo-timeline."""
        if not self._sl_on:
            return
        with self._lock:
            self._stepline.note_event(-1, '_lifecycle', event,
                                      t if t is not None else time.time(),
                                      **detail)

    def _note_anomaly(self, trigger: str,  # holds: _lock
                      detail: Dict[str, Any]) -> None:
        """Record the anomaly in the event ring and queue a ring dump
        (rate-limited per trigger kind). The sqlite write happens on the
        recorder's writer thread after the engine lock is released
        (:meth:`_flush_stepline_dumps`)."""
        if not self._sl_on:
            return
        now = time.time()
        detail = dict(detail, t=now, step_idx=self._stepline.steps.total)
        self._stepline.note_event(
            int(detail.get('request_id') or 0),
            str(detail.get('tenant') or ''), trigger, now,
            **{k: v for k, v in detail.items()
               if k not in ('request_id', 'tenant', 't')})
        if self._stepline.should_dump(trigger, now):
            self._pending_dumps.append((trigger, detail))

    def _flush_stepline_dumps(self) -> None:
        """Hand queued anomaly dumps to the background writer, outside
        the engine lock (the step's and submit's tails): the ring is
        copied under the lock, rendered and written on the writer
        thread."""
        if not self._sl_on:
            return
        with self._lock:
            if not self._pending_dumps:
                return
            pending, self._pending_dumps = self._pending_dumps, []
            raw = self._stepline.raw()

        def render(pending=pending, raw=raw):
            snap = stepline_lib.render_snapshot(raw)
            spans = []
            for trigger, detail in pending:
                spans.extend(stepline_lib.dump_spans(trigger, detail, snap))
            return spans

        stepline_lib.enqueue_dump(render)

    def _sl_stage(self, stage: str, start: float) -> float:
        """Append the current step's ``stage`` interval from ``start``
        (perf_counter) to now, and return now; nothing outside a
        recorded step."""
        if self._sl_stages is None:
            return 0.0
        now = time.perf_counter()
        self._sl_stages.append((stage, start - self._sl_t0, now - start))
        return now

    def _sl_begin(self) -> Optional[list]:
        """The start of a program's dispatch inside a recorded step:
        [its perf_counter time, and, once :meth:`_sl_start` has run, the
        wall time and the program's start: an event on CUDA, a
        perf_counter time on the CPU]."""
        if self._sl_stages is None:
            return None
        return [time.perf_counter(), 0.0, None]

    def _sl_start(self, begin: Optional[list]) -> None:
        """Mark the program's start in ``begin``, after its staging
        copies and just before its launch: where the stream is empty,
        the device idles until here."""
        if begin is None:
            return
        begin[1] = time.time()
        if self.device.type == 'cuda':
            begin[2] = torch.cuda.Event(enable_timing=True)
            begin[2].record()
        else:
            begin[2] = time.perf_counter()

    def _kv_read(self, decoding: List[int], r: int) -> int:
        """Keys each layer's attention reads for the decoding slots of a
        program of ``r`` queries a slot: each slot's device length (the
        host's plus the tokens in flight) plus its ``r`` new positions."""
        return sum(int(self._slot_len[s]) + self._inflight_tok[s] + r
                   for s in decoding)

    def _sl_program(self, begin: Optional[list], kind: str, bucket: int,
                    rows: int, chunks: List[tuple], kv_tokens: int,
                    end: Optional[torch.cuda.Event] = None) -> None:
        """Close the dispatch begun at ``begin``: its stage interval, and
        its program record, appended now on the CPU; on CUDA once its
        events are read (:meth:`_sl_complete`). ``end`` is the event
        after the program's read-back copy; a chunk records its own."""
        if begin is None:
            return
        t_d, t_wall, start = begin
        cuda = self.device.type == 'cuda'
        if cuda and end is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        now = self._sl_stage('dispatch', t_d)
        self._sl_programs += 1
        if kind != 'prefill':
            self._sl_batch = rows
        fields = dict(step_idx=self._stepline.steps.total, kind=kind,
                      bucket=bucket, t=t_wall, dispatch_s=now - t_d,
                      rows=rows, chunks=chunks, kv_tokens=kv_tokens)
        if not cuda:
            # The CPU runs the ops as they are called: its device time
            # is the host's.
            prev, self._sl_prev_end = self._sl_prev_end, now
            with self._lock:
                self._stepline.note_program(stepline_lib.ProgramRecord(
                    **fields, device_s=now - start,
                    gap_before_s=None if prev is None else start - prev))
            return
        self._sl_pending.append((fields, start, end, self._sl_prev_end))
        self._sl_prev_end = end

    def _sl_complete(self, event) -> None:  # holds: _lock
        """Append the pending program records up to the one whose end
        event is ``event``, which the caller has waited on: the events
        recorded before it on the stream are complete too, so reading
        them adds no sync."""
        if not any(p[2] is event for p in self._sl_pending):
            return
        while True:
            fields, start, end, prev = self._sl_pending.popleft()
            self._stepline.note_program(stepline_lib.ProgramRecord(
                **fields, device_s=start.elapsed_time(end) / 1e3,
                gap_before_s=(prev.elapsed_time(start) / 1e3
                              if prev is not None else None)))
            if end is event:
                return

    def _sl_record(self, t_wall: float, dur: float, pre: tuple) -> None:
        """Classify and append this step's record from counter deltas
        (pure observation: nothing the step loop acts on is read)."""
        (pre_pref, pre_drafted, pre_accepted, pre_steps, pre_spec,
         pre_fused, pre_tok) = pre
        stages = self._sl_stages
        sums = {'dispatch': 0.0, 'drain': 0.0, 'readback': 0.0}
        for stage, _, sec in stages:
            if stage in sums:
                sums[stage] += sec
        with self._lock:
            d_disp = self._decode_steps - pre_steps
            d_chunk = self._prefill_tokens - pre_pref
            d_tok = self._decode_tokens - pre_tok
            if d_disp:
                kind = ('mixed' if self._fused_steps - pre_fused
                        else 'verify' if self._spec_steps - pre_spec
                        else 'decode')
            elif d_chunk:
                kind = 'prefill'
            elif d_tok or any(st == 'readback' for st, _, _ in stages):
                kind = 'free'   # consumes only
            else:
                return   # an idle tick
            depth = self._sched.pending()
            tenant_depths = None
            if 0 < depth <= 512:
                tenant_depths = {}
                for r in self._sched.queued_requests():
                    tenant_depths[r.tenant] = tenant_depths.get(r.tenant,
                                                                0) + 1
            self._stepline.note_step(stepline_lib.StepRecord(
                idx=self._stepline.steps.total, t=t_wall, dur_s=dur,
                kind=kind, dispatch_s=sums['dispatch'],
                drain_s=sums['drain'], readback_s=sums['readback'],
                batch=self._sl_batch, chunk_tokens=d_chunk,
                prefilling=len(self._prefilling),
                spec_drafted=self._spec_drafted - pre_drafted,
                spec_accepted=self._spec_accepted - pre_accepted,
                pages_free=(self.allocator.free_pages
                            if self.allocator is not None else -1),
                prefix_evictions=(self.prefix.evictions
                                  if self.prefix is not None else 0),
                preemptions=self._preemptions, queue_depth=depth,
                tenant_depths=tenant_depths, stages=stages))

    def stepline_snapshot(self) -> Dict[str, Any]:
        """A copy of the recorder's rings: the GET /debug/stepline
        payload."""
        if not self._sl_on:
            return {'enabled': False, 'steps': [], 'events': []}
        with self._lock:
            raw = self._stepline.raw()
        snap = stepline_lib.render_snapshot(raw)
        snap['enabled'] = True
        snap['ttft_slo_s'] = self.ecfg.ttft_slo_s
        return snap

    def stepline_summary(self) -> Dict[str, Any]:
        """The stage breakdown over the retained steps (dispatch, drain,
        readback, host: seconds and shares of the step time)."""
        if not self._sl_on:
            return {'enabled': False}
        with self._lock:
            recs = self._stepline.steps.snapshot()
        out = stepline_lib.summarize(recs)
        out['enabled'] = True
        return out

    # ---- metrics ---------------------------------------------------------
    def ttft_window(self) -> List[float]:
        """Locked snapshot of the recent-TTFT window (what a pool merges
        from HTTP threads, never the live deque)."""
        with self._lock:
            return list(self._ttfts)

    def queue_wait_window(self) -> List[float]:
        """Locked snapshot of the recent queue-wait window."""
        with self._lock:
            return list(self._queue_waits)

    def compiled_counts(self) -> Dict[str, int]:
        """Step programs per kind, as the reference reports its compiled
        programs: on the card the CUDA graphs captured or about to be,
        one per (kind, queries per slot or chunk bucket, samples) key; on
        the CPU or with graphs off, the distinct step shapes run eagerly.
        Greedy steady state: prefill one per chunk bucket used, decode 1,
        verify 1 per draft width once speculation ran, and (fused on
        only) mixed one per chunk bucket used. Slot frees are eager
        index writes, not programs. With the prefix cache, ``cow`` is 0:
        a page copy-on-write is an eager in-place copy, and a chunk at a
        matched offset runs its bucket's program (the offset is read on
        the device), so the cache adds no program."""
        out = {'prefill': 0, 'decode': 0}
        if self._fused:
            out['mixed'] = 0
        if self.prefix is not None:
            out['cow'] = 0
        # A copy: metrics() calls this from HTTP threads while the engine
        # thread may add a program.
        for kind, _, _ in list(self._programs):
            out[kind] = out.get(kind, 0) + 1
        return out

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            ttfts = sorted(self._ttfts)
            waits = sorted(self._queue_waits)
            snap = self._sched.snapshot()
            c = dict(fused=self._fused_steps, stalls=self._stall_steps,
                     sl_steps=(self._stepline.steps.total
                               if self._sl_on else 0),
                     sl_dumps=self._stepline.dumps if self._sl_on else 0,
                     sdc=self._sdc_events,
                     suspect=self._integrity_suspect,
                     steps=self._decode_steps, tokens=self._decode_tokens,
                     time=self._decode_time, spec_k=self._spec_k,
                     spec_steps=self._spec_steps,
                     spec_slot_steps=self._spec_slot_steps,
                     spec_drafted=self._spec_drafted,
                     spec_accepted=self._spec_accepted,
                     spec_emitted=self._spec_emitted,
                     prefill_tokens=self._prefill_tokens,
                     prefill_chunks=self._prefill_chunks,
                     scheduler=self._sched.name,
                     waiting=self._sched.pending(),
                     queued_tokens=self._sched.queued_tokens(),
                     active=sum(1 for r in self._slots if r is not None),
                     abandoned=self._abandoned, expired=self._expired,
                     cancelled=self._cancelled,
                     preemptions=self._preemptions,
                     in_flight=sum(self._inflight_tok),
                     pages_free=(self.allocator.free_pages
                                 if self.allocator is not None else 0),
                     kv_transfers=self._kv_transfers,
                     kv_bytes=self._kv_transfer_bytes,
                     kv_failures=self._kv_transfer_failures,
                     kv_window=sorted(self._kv_transfer_window))
            prefix_stats = (self.prefix.stats() if self.prefix is not None
                            else {})
        kvw = c['kv_window']
        return {
            'decode_steps': c['steps'],
            'decode_tokens': c['tokens'],
            'decode_tokens_per_sec': (c['tokens'] / c['time']
                                      if c['time'] else 0.0),
            'tokens_per_step': (round(c['tokens'] / c['steps'], 4)
                                if c['steps'] else None),
            **({'spec_k': c['spec_k'],
                'spec_steps': c['spec_steps'],
                'spec_slot_steps': c['spec_slot_steps'],
                'spec_drafted_tokens': c['spec_drafted'],
                'spec_accepted_tokens': c['spec_accepted'],
                'spec_emitted_tokens': c['spec_emitted'],
                'spec_accept_rate': (round(
                    c['spec_accepted'] / c['spec_drafted'], 4)
                    if c['spec_drafted'] else 0.0),
                'accepted_len_mean': (round(
                    c['spec_emitted'] / c['spec_slot_steps'], 4)
                    if c['spec_slot_steps'] else None)}
               if (c['spec_k'] or c['spec_steps']) else {}),
            'prefill_tokens': c['prefill_tokens'],
            'prefill_tokens_per_step': (round(
                c['prefill_tokens'] / c['steps'], 4)
                if c['steps'] else None),
            'prefill_chunks': c['prefill_chunks'],
            # Mixed dispatches, and steps where decoding slots waited on
            # standalone chunks (about 0 with fused_prefill on).
            'fused_steps': c['fused'],
            'decode_stall_steps': c['stalls'],
            'ttft_p50_s': ttfts[len(ttfts) // 2] if ttfts else None,
            'queue_wait_p50_ms': (round(waits[len(waits) // 2] * 1e3, 3)
                                  if waits else None),
            'queue_wait_p99_ms': (round(
                waits[min(len(waits) - 1, int(len(waits) * 0.99))] * 1e3,
                3) if waits else None),
            'scheduler': c['scheduler'],
            'num_waiting': c['waiting'],
            'queued_tokens': c['queued_tokens'],
            'tenants': sched_lib.aggregate_stats([snap], c['time']),
            'num_active': c['active'],
            'requests_abandoned': c['abandoned'],
            'requests_expired': c['expired'],
            'requests_cancelled': c['cancelled'],
            'pipeline_depth': self._depth,
            'tokens_in_flight': c['in_flight'],
            # Flight recorder: steps recorded (monotonic) and anomaly
            # dumps triggered.
            'stepline_steps': c['sl_steps'],
            'stepline_dumps': c['sl_dumps'],
            # SDC sentinel hits and the one-way verdict.
            'sdc_events_total': c['sdc'],
            'integrity': 'suspect' if c['suspect'] else 'ok',
            # KV prefix transfers this replica took part in (exports served
            # and imports applied), wire bytes moved, transfers that died
            # anywhere on the pull path, and the p99 wall time of a recent
            # window.
            'kv_transfers_total': c['kv_transfers'],
            'kv_transfer_bytes': c['kv_bytes'],
            'kv_transfer_failures': c['kv_failures'],
            'kv_transfer_p99_s': (round(
                kvw[min(len(kvw) - 1, int(len(kvw) * 0.99))], 6)
                if kvw else None),
            'cuda_graphs': self._graphs_on,
            'step_programs': self.compiled_counts(),
            **({'paged': True,
                'page_size': self.allocator.page_size,
                'pages_total': self.allocator.n_pages,
                'pages_free': c['pages_free'],
                'preemptions': c['preemptions'],
                'kv_dtype': self.ecfg.kv_dtype,
                'kv_page_bytes': self._kv_page_bytes()}
               if self.allocator is not None else {'paged': False}),
            # Device bytes of the KV cache (the page pool, scales included,
            # or the dense slots).
            'kv_cache_bytes': self._kv_cache_bytes(),
            'device': str(self.device),
            # Device bytes of the weights (int8 + scales with quantize).
            'param_bytes': self._param_bytes,
            # Launches of each hand-written kernel in this process (the
            # wrappers' counters, graph replays included): shows the
            # path ran through them.
            'kernel_launches': {**paged_attn.launches,
                                **quant_lib.launches},
            **prefix_stats,
        }

    def _kv_cache_bytes(self) -> int:
        c = self.cache
        if self.allocator is None:
            return c.nbytes()
        return sum(t.numel() * t.element_size()
                   for t in (c.k_pages, c.v_pages, c.k_scales, c.v_scales)
                   if t is not None)

    def _kv_page_bytes(self) -> int:
        """Device bytes one physical page costs across every layer: K
        plus V values at their dtype, plus the fp32 row scales on int8
        pages."""
        cfg, page = self.config, self.allocator.page_size
        rows = 2 * cfg.n_layers * cfg.n_kv_heads * page
        out = rows * cfg.head_dim * self.cache.k_pages.element_size()
        if self.cache.k_scales is not None:
            out += rows * self.cache.k_scales.element_size()
        return out


class EnginePool:
    """Length-routed pool of engines: two-tier KV for long context (the
    reference's ``EnginePool``).

    The dense per-slot cache prices every slot at its engine's longest
    sequence; a pool routes each request to the smallest engine (tier)
    whose cache fits its prompt, so the KV bytes are sum(slots_i * seq_i)
    (16 x 2048 + 2 x 8192) rather than every slot paying the longest
    length. The tiers share one params object: the weights are on the
    device once. Each tier keeps its own cache, step programs, scratch
    and host ring, and the pool steps them in turn on one stream.

    The surface is the one the server calls. Routing is a pure function of
    the submission order, and each tier counts request ids in its own
    residue class, so ids never collide across tiers."""

    def __init__(self, engines: List[InferenceEngine]) -> None:
        if not engines:
            raise ValueError('empty engine pool')
        self.engines = sorted(engines, key=lambda e: e.ecfg.max_seq_len)
        for i, eng in enumerate(self.engines):
            eng._ids = itertools.count(i + 1, len(self.engines))

    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, spec: bool = True,
               deadline: Optional[float] = None,
               tenant: str = sched_lib.DEFAULT_TENANT,
               resume_tokens: Optional[Sequence[int]] = None) -> Request:
        """Submit to the first tier whose cache holds prompt + resume
        (ValueError when none does)."""
        n = len(prompt_tokens) + len(resume_tokens or ())
        for eng in self.engines:
            if n <= eng.ecfg.max_seq_len - 1:
                return eng.submit(prompt_tokens, max_new_tokens, temperature,
                                  spec=spec, deadline=deadline, tenant=tenant,
                                  resume_tokens=resume_tokens)
        raise ValueError(
            f'prompt ({n} tokens) exceeds every pool tier (largest: '
            f'{self.engines[-1].ecfg.max_seq_len - 1})')

    def tier_of(self, req: Request) -> int:
        """The index of the tier serving ``req`` (its id's residue)."""
        return (req.request_id - 1) % len(self.engines)

    def cancel(self, req: Request) -> bool:
        return self.engines[self.tier_of(req)].cancel(req)

    def step(self) -> int:
        return sum(e.step() for e in self.engines)

    # ---- KV prefix transfers: one advertised index per replica, the first
    # tier with a prefix cache (dense tiers have none) ----------------------
    def _kv_engine(self) -> InferenceEngine:
        for e in self.engines:
            if e.prefix is not None:
                return e
        raise ValueError('no engine in the pool has a prefix cache')

    def kv_index_armed(self) -> bool:
        return any(e.prefix is not None for e in self.engines)

    def kv_page_size(self) -> int:
        return (self._kv_engine().kv_page_size()
                if self.kv_index_armed() else 0)

    def kv_index_snapshot(self, since_gen: int = -1):
        if not self.kv_index_armed():
            return None
        return self._kv_engine().kv_index_snapshot(since_gen)

    def request_kv_export(self, tokens: Sequence[int]) -> _KVJob:
        return self._kv_engine().request_kv_export(tokens)

    def request_kv_import(self, blob: bytes, fetch_s: float = 0.0) -> _KVJob:
        return self._kv_engine().request_kv_import(blob, fetch_s=fetch_s)

    def note_kv_transfer_failure(self) -> None:
        self._kv_engine().note_kv_transfer_failure()

    def kv_transfer_window(self) -> List[float]:
        return sorted(x for e in self.engines for x in e.kv_transfer_window())

    # ---- knobs --------------------------------------------------------------
    def set_pipeline_depth(self, depth: int) -> None:
        for e in self.engines:
            e.set_pipeline_depth(depth)

    def set_wallclock_cancel(self, enabled: bool) -> None:
        for e in self.engines:
            e.set_wallclock_cancel(enabled)

    def set_spec_k(self, k: int) -> None:
        for e in self.engines:
            e.set_spec_k(k)

    def set_scheduler(self, name: str, tenant_weights=None) -> None:
        for e in self.engines:
            e.set_scheduler(name, tenant_weights)

    def set_tenant_weights(self, weights) -> None:
        for e in self.engines:
            e.set_tenant_weights(weights)

    # ---- flight recorder and integrity --------------------------------------
    def note_lifecycle_event(self, event: str, t: Optional[float] = None,
                             **detail: Any) -> None:
        """Lifecycle milestones land on tier 0 (the merged snapshot
        interleaves them with every tier's requests)."""
        self.engines[0].note_lifecycle_event(event, t, **detail)

    def stepline_snapshot(self) -> Dict[str, Any]:
        """The tiers' recorder snapshots merged on the shared wall clock
        (each step carries its own tier's program records)."""
        tiers = [e.stepline_snapshot() for e in self.engines]
        return {
            'enabled': any(t.get('enabled') for t in tiers),
            'dumps': sum(t.get('dumps', 0) for t in tiers),
            'steps_total': sum(t.get('steps_total', 0) for t in tiers),
            'programs_total': sum(t.get('programs_total', 0)
                                  for t in tiers),
            'steps': sorted((r for t in tiers for r in t.get('steps', [])),
                            key=lambda r: r['t']),
            'events': sorted((ev for t in tiers
                              for ev in t.get('events', [])),
                             key=lambda ev: ev['t']),
            'tiers': len(tiers),
        }

    def stepline_summary(self) -> Dict[str, Any]:
        on = [t for t in (e.stepline_summary() for e in self.engines)
              if t.get('enabled')]
        if not on:
            return {'enabled': False}
        if len(on) == 1:
            return on[0]
        return {'enabled': True, 'tiers': on}

    def integrity_suspect(self) -> bool:
        return any(e.integrity_suspect() for e in self.engines)

    def output_digest(self) -> int:
        return zlib.crc32(','.join(
            str(e.output_digest()) for e in self.engines).encode())

    # ---- driving --------------------------------------------------------------
    def idle(self) -> bool:
        return all(e.idle() for e in self.engines)

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if self.idle():
                return
            self.step()

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0) -> List[Request]:
        reqs = [self.submit(p, max_new_tokens, temperature) for p in prompts]
        self.run_until_idle()
        return reqs

    def metrics(self) -> Dict[str, Any]:
        """The tiers' metrics merged as the reference merges them: rates
        over the summed decode time (the tiers share the device), windows
        and per-tenant stats merged from the raw snapshots, counters
        summed, each tier's own metrics under ``tiers``."""
        tiers = [e.metrics() for e in self.engines]
        total_time = sum(e._decode_time for e in self.engines)
        total_tokens = sum(t['decode_tokens'] for t in tiers)
        total_steps = sum(t['decode_steps'] for t in tiers)
        total_prefill = sum(t['prefill_tokens'] for t in tiers)
        ttfts = sorted(x for e in self.engines for x in e.ttft_window())
        waits = sorted(x for e in self.engines for x in e.queue_wait_window())
        kvw = self.kv_transfer_window()
        prefixed = [e.prefix for e in self.engines if e.prefix is not None]
        prefix_agg = {}
        if prefixed:
            hits = sum(p.hits for p in prefixed)
            total = hits + sum(p.misses for p in prefixed)
            prefix_agg = {
                'prefix_hit_rate': round(hits / total, 4) if total else 0.0,
                'prefix_tokens_saved': sum(p.tokens_saved for p in prefixed),
                'prefix_cached_pages': sum(p.cached_pages for p in prefixed),
                'prefix_evictions': sum(p.evictions for p in prefixed),
                'prefix_hits': hits,
                'prefix_misses': total - hits,
                'prefix_indexed_pages': sum(p.indexed_pages
                                            for p in prefixed),
            }
        spec_tiers = [t for t in tiers if 'spec_steps' in t]
        spec_agg = {}
        if spec_tiers:
            drafted = sum(t['spec_drafted_tokens'] for t in spec_tiers)
            accepted = sum(t['spec_accepted_tokens'] for t in spec_tiers)
            emitted = sum(t['spec_emitted_tokens'] for t in spec_tiers)
            lanes = sum(t['spec_slot_steps'] for t in spec_tiers)
            spec_agg = {
                'spec_k': max(t['spec_k'] for t in spec_tiers),
                'spec_steps': sum(t['spec_steps'] for t in spec_tiers),
                'spec_slot_steps': lanes,
                'spec_drafted_tokens': drafted,
                'spec_accepted_tokens': accepted,
                'spec_emitted_tokens': emitted,
                'spec_accept_rate': (round(accepted / drafted, 4)
                                     if drafted else 0.0),
                'accepted_len_mean': (round(emitted / lanes, 4)
                                      if lanes else None),
            }

        def pct(window, q):
            return window[min(len(window) - 1, int(len(window) * q))]

        return {
            **prefix_agg,
            **spec_agg,
            'kv_transfers_total': sum(t['kv_transfers_total'] for t in tiers),
            'kv_transfer_bytes': sum(t['kv_transfer_bytes'] for t in tiers),
            'kv_transfer_failures': sum(t['kv_transfer_failures']
                                        for t in tiers),
            'kv_transfer_p99_s': round(pct(kvw, 0.99), 6) if kvw else None,
            'decode_steps': total_steps,
            'decode_tokens': total_tokens,
            'decode_tokens_per_sec': (total_tokens / total_time
                                      if total_time else 0.0),
            'tokens_per_step': (round(total_tokens / total_steps, 4)
                                if total_steps else None),
            'prefill_tokens': total_prefill,
            'prefill_tokens_per_step': (round(total_prefill / total_steps, 4)
                                        if total_steps else None),
            'fused_steps': sum(t['fused_steps'] for t in tiers),
            'decode_stall_steps': sum(t['decode_stall_steps'] for t in tiers),
            'ttft_p50_s': ttfts[len(ttfts) // 2] if ttfts else None,
            'queue_wait_p50_ms': (round(waits[len(waits) // 2] * 1e3, 3)
                                  if waits else None),
            'queue_wait_p99_ms': (round(pct(waits, 0.99) * 1e3, 3)
                                  if waits else None),
            'scheduler': tiers[0]['scheduler'],
            'num_waiting': sum(t['num_waiting'] for t in tiers),
            'queued_tokens': sum(t['queued_tokens'] for t in tiers),
            'tenants': sched_lib.aggregate_stats(
                [e.sched_snapshot() for e in self.engines], total_time),
            'num_active': sum(t['num_active'] for t in tiers),
            'requests_abandoned': sum(t['requests_abandoned']
                                      for t in tiers),
            'requests_expired': sum(t['requests_expired'] for t in tiers),
            'requests_cancelled': sum(t['requests_cancelled']
                                      for t in tiers),
            'pipeline_depth': max(t['pipeline_depth'] for t in tiers),
            'tokens_in_flight': sum(t['tokens_in_flight'] for t in tiers),
            'stepline_steps': sum(t.get('stepline_steps', 0) for t in tiers),
            'stepline_dumps': sum(t.get('stepline_dumps', 0) for t in tiers),
            # One suspect tier poisons the pool: the tiers share a card.
            'sdc_events_total': sum(t.get('sdc_events_total', 0)
                                    for t in tiers),
            'integrity': ('suspect' if any(t.get('integrity') == 'suspect'
                                           for t in tiers) else 'ok'),
            'tiers': [{'max_seq_len': e.ecfg.max_seq_len,
                       'n_slots': e.ecfg.n_slots, **t}
                      for e, t in zip(self.engines, tiers)],
            # The port's own keys, as a single engine reports them.
            'paged': any(t['paged'] for t in tiers),
            'cuda_graphs': any(t['cuda_graphs'] for t in tiers),
            'device': tiers[0]['device'],
            'param_bytes': tiers[0]['param_bytes'],
            'kv_cache_bytes': sum(t['kv_cache_bytes'] for t in tiers),
            'kernel_launches': tiers[0]['kernel_launches'],
        }
