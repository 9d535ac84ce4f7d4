#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``skypilot_tpu_torch``) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero:

1. Card check: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel source of the port from
   ``skypilot_tpu_torch/ops/csrc`` with ``nvcc`` (one process per
   source, all seven started together) and prints the seconds and the
   compiler's register/spill report and warnings; then reads the
   compiled kernels back (``cuobjdump -sass``) and fails unless every
   instance of the flash forward, dQ and dK/dV kernels and the fused
   cross-entropy forward holds wgmma products (``HGMMA``), TMA tile
   loads (``UTMALDG``) and mbarrier operations (``SYNCS``), and every
   instance of the paged decode/verify
   and prefill kernels (bf16 and int8) and of the int8-weight product
   ``mma.sync`` products (``HMMA``) and ``cp.async`` copies (``LDGSTS``).
3. Kernel vs plain: each kernel is held against its plain PyTorch
   version on the same inputs, at a stated tolerance. The paged kernels
   at the Llama-3-8B shapes (8 KV heads, group 4, head_dim 128, pages of
   64 bf16 rows), then at every head_dim, group and page size they take;
   the speculative verify kernel (5 queries per slot, one slot's run at
   the block table's coverage edge) and the int8 flavors of decode,
   prefill and verify (pages and scales from ``quantize_rows`` of random
   bf16 rows) at the same shapes, then at every head_dim, group, page
   size and (verify) query count, where each verify run's query i must
   also be bitwise the decode kernel's output at lengths + i + 1 (capped
   at the table's coverage), for every i; decode and
   verify also at lengths on the edges of the kernel's page splits
   (``split_edges``), and prefill at prefixes on its own split edges
   (``prefill_split_edges``) and at the long prefix of phase 4, at the
   8B shapes and in every variant; prefill must also leave its output
   bitwise unchanged when the K/V rows past the slot's frontier hold
   NaN, and at every one of its cases its device-scalar entry (offset
   and true_len read on the card from 0-d int32 tensors, a grid over the
   whole table row: what the engine's chunk graphs launch) must give the
   host-scalar entry's output bit for bit;
   the flash attention forward (out, lse) and backward (dq, dk, dv) at
   the bench_1b shapes (b 6, 12 heads, s 2048, d 128, causal), where the
   backward must also give the same bits on two runs, then at head_dim
   64/128 x group 1/2/4/8 x causal/not, at s 192 (an odd multiple of
   64: the forward's and dK/dV's 128-row CTAs only half fit at the
   end); the fused cross-entropy
   forward (nll, lse) at T 12288, d 1536, V 32768, where it must also
   give the same bits on two runs, then at a vocabulary that is not a
   multiple of its tile, with targets in the last tile and outside the
   vocabulary, at vocabularies one tile short of, on and one tile past
   the edge of its vocabulary splits (``ce_split_edges``), at llama-350m's
   d 1024 x V 32768 and at Llama-3's head, d 4096 x V 128,256; the
   int8-weight product (``qdot_int8``, W8A16) at every weight shape of the
   8B and 350m models, at an N off its tile and at a tensor-parallel
   rank's slice of every 8B weight at tp 2 and tp 8 (``QDOT_TP_SHAPES``:
   tp 8's lm_head N 16,032 is off the 128-column block), at 1, 17, 64,
   128 and 256 rows, where every row must also be bitwise the same row
   of the 256-row product (also through a 1-D and a 3-D x); and the
   decode, verify and prefill kernels at a tensor-parallel rank's KV
   heads (4 at tp 2, 1 at tp 8; ``TP_HKV``) over 8 dense slots of 32
   pages, every verify query bitwise decode and the device-scalar
   prefill entry bitwise the host one; phase 4 times tp 2's shapes; and
   the flash forward, dQ and dK/dV at a tensor-parallel training rank's
   heads (``FLASH_TP_SHAPES``: bench_1b at tp 2, 6 heads; Llama-3-8B at
   tp 2, 16 query and 4 KV heads at seq 4096), at phase 7e's ring
   blocks (``FLASH_RING_SHAPES``, causal and full) and at 7f's and 7g's
   attention shapes (``FLASH_PATH_SHAPES``: a bench_1b microbatch of 1 x
   2048, Mixtral-8x7B's 32 query and 8 KV heads at b 2 and b 1, s 2048),
   which phase 4 times; and the AdamW update (``csrc/adamw.cu``) bitwise
   the eager chain at the ft stage's ``w_gate`` (bf16) and at a ragged
   length for every (param, mu) dtype pair, clip on and off.
4. Timing: each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls:
   ``scaled_dot_product_attention`` for attention, its backward through
   autograd, ``matmul`` + ``logsumexp`` for the cross-entropy, ``matmul``
   with the bf16 dequantized weight for the int8-weight product, which
   is also timed beside ``torch._weight_int8pack_mm``, one
   ``torch._fused_adamw_`` call for the AdamW update), by CUDA
   events with the L2 cache flushed between launches and a sleep kernel
   ahead of each, so the events time the device's work and not the
   host's enqueueing; plus the least time the card could take for the
   same work (``bound_ms``). Prefill is timed twice: a 256-token chunk
   at offset 192 and the last 256-token chunk of a 2048-token prompt,
   each from its host-scalar and its device-scalar entry; the int8-weight
   product at each 8B weight at 64 and 256 rows.
5. Serving end to end: starts ``python -m skypilot_tpu_torch.infer.server
   --model 8b --slots 8 --max-seq-len 2048 --spec-k 4`` (full width and
   depth, random weights from a seed; the server's default control loop:
   fcfs, pipeline depth 1, the decode and verify steps replayed as CUDA
   graphs; ``--paged``, the paged cache) in a subprocess, serves
   mixed-length requests (one streamed) twice through ``/generate``, then
   a burst of short prompts that decodes on all 8 slots; checks token
   counts and that a repeated greedy request gives the same tokens,
   prints TTFT, time between tokens and tokens/s; then sends repetitive
   prompts with ``"spec": false`` and with speculation on, which must
   give the same tokens, and prints ``accepted_len_mean``; reads each
   paged kernel's launches during those requests from ``/metrics``. Then
   the same against a second server with ``--kv-dtype int8 --spec-k 4``,
   whose three int8 kernels must all launch, printed beside the bf16
   numbers with ``kv_page_bytes``.
5b. The control loop in process at full 8B width and depth (random
   weights, seed 0), 8 prompts x 64 new tokens, for bf16 and for int8
   pages: the synchronous eager loop (pipeline depth 0, CUDA graphs off)
   and the default loop (depth 1, graphs on) must give identical greedy
   tokens, with speculation off and with it on (an oracle drafter that
   proposes the speculation-off continuation, wrong at a fixed draft
   index for half the prompts); speculation on must give
   speculation-off's tokens exactly and accept drafts; no page may leak;
   the default loop must hold one decode graph and one verify graph;
   the wall time of each pass is printed.
5c. The default loop with speculation on over a pool cut to 20 usable
   pages (the requests need 33): it must preempt, give the uncut pool's
   tokens (a preempted request, whose K/V the resume recomputes through
   prefill's products, may part after its resume only at a near-tie of
   the uncut continuation's top-2 logits, printed), return every page
   and keep one decode and one verify graph; then the int8-vs-bf16
   decode-logit delta at these shapes, which must be > 0.
5d. Fused mixed steps in process at full 8B width and depth, bf16 and
   int8 pages: 5b's prompts plus a 768-token aggressor arriving
   mid-decode; fused on vs off, at depth 0 eager and at depth 1 with
   CUDA graphs, speculation off and on, every token list identical, one
   mixed graph per chunk bucket; the SDC sentinel off gives the same
   tokens, steps and programs; a NaN planted in the embedding row of a
   token only one prompt holds finishes that request ``'sdc'`` and turns
   the server's ``/health`` 503 ``corrupt``, and the requests served
   after it keep the clean run's tokens.
5e. The shared-prefix KV cache in process at full 8B width and depth,
   bf16 and int8 pages, the cache on over a pool cut to 52 pages (the
   cache off over the full pool): a 1,024-token system block with
   16-token tails (the first alone, seeding the tree, then seven beside a
   1,792-token unique prompt, then a repeat), 40 new tokens each. The
   cache-off engine at depth 0 eager is the reference; the cache-on
   engine at depth 0 eager and depth 1 with CUDA graphs, speculation off
   and on (the oracle drafter), and fused, must give its token lists
   exactly (a request it preempted may part after its resume only at a
   near-tie, as in 5c: the resume recomputes the decoded tokens' K/V
   through prefill), attach the system block for every tail after the
   seed, preempt at least once, add no step program (``cow: 0``), leak no
   page, keep every page the tree holds bytewise as donated, and launch
   the prefill (device-scalar entry), decode and verify kernels, whose
   counts in these runs go into the kernel line as
   ``launches_prefix_cache``. Then KV prefix transfer between two
   in-process engines: the int8 blob is ``page_wire_bytes`` a page plus
   its header, the import is byte-exact and its tokens are a local
   recompute's; a bf16 import lands within half a scale step; export and
   import ms; and the wire's numpy quantizer is bitwise the card's int8
   write path. Then ``skypilot_tpu_torch.bench_ttft --sweep chunked`` at
   one level (7 victims and the aggressor on 8 slots, chunk buckets 64
   and 128; its kv-dtype axis now runs the prefix cache through a bf16
   and an int8 pool of the same bytes): its JSON document on a line of
   its own.
5f. int8 weights at full 8B width and depth: the card's quantizer bitwise
   the CPU's on layer 0's weights and the embedding; in process with
   ``EngineConfig(quantize=True)``, bf16 pages, 5b's prompts: depth 0
   eager vs depth 1 with graphs, speculation on (the oracle drafter) vs
   off, and with 5d's aggressor fused on vs off, every token list
   identical, one graph per program kind, no page leaked, the int8 tree
   at most 0.55 of the bf16 tree's bytes; then the server with
   ``--quantize --spec-k 4`` as in phase 5 (a repeated greedy request,
   ``"spec": false`` vs on, ``qdot_int8`` launched), its TTFT, time
   between tokens and tokens/s printed beside the bf16 server's.
5g. The dense KV cache (the reference server's default) at full 8B width
   and depth. Phase 3 has held the prefill kernel over the dense cache's
   page view (identity rows of 32 and 128 pages) at C 16, 64 and 256,
   offsets up to 1792 and 7936, and decode and verify over identity rows
   (3 of 128 pages at contexts up to 8192, 16 of 32 pages), and phase 4
   timed prefill at C 16 and at the 128-page row. In process, bf16, 5b's prompts on 8 dense slots: depth
   0 eager vs depth 1 with graphs, speculation on (the oracle drafter)
   and fused on, every token list identical; one decode and one verify
   graph, at most three chunk and three mixed graphs; the decode,
   prefill and verify kernels launched (``launches_dense`` in the kernel
   line); the paged engine on the same weights may part from the dense
   tokens only at a near-tie (printed). Then the replica at the
   reference's ``examples/serve_llm.yaml`` single-chip flags with its
   long tier (``--model 8b --quantize --slots 16 --max-seq-len 2048
   --long-slots 2 --long-seq-len 8192 --spec-k 4``, no ``--paged``):
   ``coldstart.compiled`` only after both tiers' warm-up, each tier's
   every greedy program (a chunk graph a bucket, decode, verify)
   captured before ready, phase 5's
   burst, ``paged: false``, and a 3,000-token prompt (twice) routed to
   the long tier with an in-process long-tier engine's tokens; prints
   the time between tokens, tokens/s, the long prompt's warm TTFT and
   each tier's KV bytes beside the card.
5h. Tensor parallelism: two spawned ranks share the card over ``gloo``
   at tp 2 (``tp_rank``; a correctness run: gloo's collectives stage
   through the host, so the engines run without CUDA graphs), 8B dense,
   bf16 and then int8 weights, spec_k 4 with the oracle drafter, 5b's
   first TP_PROMPTS prompts served through the lockstep driver. Their
   tokens must equal the tp=1 engine's (except after a near-tie of its
   top-2 logits, NEAR_TIE), both ranks must have launched decode,
   prefill and verify (and ``qdot_int8`` with int8 weights: the
   ``launches_tp2`` of the kernel line), and the lockstep loop compares
   the ranks' output digests every tick. Prints each rank's time a tick and
   a step, labelled gloo on one card. The NCCL path (one card a rank)
   needs two cards and does not run here.
5i. The rest of the replica: ``bench_ttft``'s coldstart boots of the
   server at the serving recipe's single-chip flags with ``--spec-k 6
   --scheduler wfq --max-queue-requests 64`` (dense, int8 weights), twice
   against one fresh ``--compile-cache-dir``: boot 1 must compile the
   library of every kernel source the replica launches (``paged_decode``,
   ``paged_prefill``, ``qdot_int8``) into it, boot 2 nothing, leaving
   every library's mtime as it was, and both must answer a fixed greedy
   prompt alike. Against boot 2: phase 5's speculation check (so that
   verify runs), one ``speculative`` level (8 in flight, greedy tokens
   bitwise with speculation on and off), one ``tenants`` level (3 s of
   the 10:1 trace, both tenants served) and one ``chaos-resume`` level
   (16 requests at 4 in flight, every stream completed, and every spliced
   stream bitwise the tokens an in-process engine of the replica's flags
   and weights gives the same resume: the splice loses, repeats and
   changes nothing. A spliced stream may part from its uninterrupted
   twin, since the resume recomputes the delivered tokens' K/V through
   prefill, as a preemption's resume does (``ROADMAP.md`` queue 3 item
   B), but only at a near-tie of the twin: both tokens where they part
   within RESUME_TIE_STEPS bf16 steps of the twin's top logit there;
   each parting is printed with its cut and margin);
   decode, prefill, verify and ``qdot_int8``
   launched in those runs (``launches_sweeps`` in the kernel line). Then
   the flight recorder's profile smoke (``python -m
   skypilot_tpu_torch.observability.stepline``) on the card. Prints each
   boot's time to ready and nvcc seconds and the sweep heads.
6. The training slice against its plain path: a 2-layer model at
   bench_1b width (b 1, s 2048, the same bf16 params), ``loss_fn`` with
   flash attention and the fused cross-entropy (the kernels) against
   dense attention and the dense cross-entropy (no kernel): the loss and
   every gradient leaf, by relative norm.
6b. The remat policies on the same slice: ``save_attn`` and ``dots``
   against ``full`` (the loss bitwise, every gradient leaf by relative
   norm, the bitwise leaves counted) and the flash forward's launches: 2
   a layer under ``full`` and ``dots``, 1 under ``save_attn``.
7. Training end to end: ``python -m skypilot_tpu_torch.bench --attn
   flash --ce fused`` (bench_1b at full width and depth) in a subprocess,
   whose JSON gives tokens/s, MFU, step time, peak memory and each
   training kernel's launches over its timed steps (counters reset just
   before them; every run must launch ``adamw_update`` once a leaf a
   step), then the same with ``--ce dense`` for comparison, then
   with ``--ce fused --remat-policy save_attn`` and ``dots`` (24 flash
   forward launches a step under ``save_attn``, 48 under ``dots``; their
   tokens/s, MFU and peak memory beside full's); then
   ``python -m skypilot_tpu_torch.train.run --model llama-350m --steps 4
   --batch 4 --seq 2048`` with a checkpoint every 2 steps, and again with
   ``--steps 6``, which must resume at step 4.
7b. ``server --model 350m --checkpoint <phase 7's directory> --quantize``
   answers 8 greedy requests, whose tokens must equal an in-process
   engine's on ``restore_to_host`` + ``quantize_params(..., 'cuda')`` of
   the same directory; ``qdot_int8`` must have launched in the server.
7c. Sharded training: ``train.run``'s rank program (``run_rank``) for
   llama-350m at seq 512, batch 4, 3 steps, on 4 spawned ranks sharing
   the card at fsdp 2 x tp 2 over ``gloo`` (named explicitly: a
   correctness run, every collective staged through the host), at lr
   0.02, with a checkpoint at steps 1 and 2: every rank's losses within
   MESH_LOSS_ATOL of the one-rank run's, whose lr 0 control (the state
   left unchanged) must part from it by more than MESH_CONTROL_X times
   that, the flash forward, dQ and dK/dV launched on every rank and
   ``adamw_update`` once a leaf a step on each (``launches_train_mesh``
   in the kernel line),
   and the mesh's step-2 checkpoint (the whole state, written by rank 0)
   resumed at one rank lands on the mesh's step-3 loss. Prints the time
   a step, labelled gloo on one card. NCCL (one card a rank) needs more
   cards and does not run here.
7d. ResNet DDP: ``run_vision``'s rank program (ResNet-50, bf16, batch
   32 at 224, 3 steps) at dp 2, two gloo ranks on the card, against one
   rank within VISION_LOSS_RTOL; prints images/s (gloo on one card).
7e. Ring attention (``ops/ring_attention.py``) at Llama-3-8B's heads (32
   query, 8 KV heads of 128, bf16) over 8,192 rows at sp 2, two gloo
   ranks on the card, forward and backward through the flash kernels:
   against one rank's flash attention over the whole rows and the plain
   ring on the same values in fp32; each rank launches each flash
   kernel once a block the causal mask keeps (rank r: r + 1), and a
   shard the kernels refuse raises. Phases 3 and 4 hold and time the
   kernels at its blocks, causal and full (rows 5r and 6r).
7f. The GPipe pipeline (``parallel/pipeline.py``): bench_1b at its 24
   layers, pp 2 as two gloo ranks, 4 microbatches of 1 x 2048, against
   one rank's ``llama.loss_fn``: losses within MESH_LOSS_ATOL, gradients
   within PP_GRAD_REL by relative norm, the flash kernels launched on
   both ranks. Phases 3 and 4 hold and time the kernels at its
   microbatch's attention (rows 5p and 6p).
7g. The MoE (``models/moe.py``) at Mixtral-8x7B's width cut to 2 layers
   (MOE_REDUCED), b 2 x s 2048, ep 2 as two gloo ranks against ep 1 in
   process: loss and aux terms within MESH_LOSS_ATOL, gradients within
   MOE_GRAD_REL, three SGD steps lower the loss, the flash kernels
   launched on both ranks; prints the peak memory. Phases 3 and 4 hold
   and time the kernels at its attention, b 2 (ep 1) and b 1 (an ep 2
   rank) (rows 5p and 6p). The launches of 7e-7g go
   into the kernel line as ``launches_ring``, ``launches_pipeline`` and
   ``launches_moe``.

Then it prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.

Run from the root of the repository: ``python3 chip_smoke.py`` (one
card). ``--kernels-only`` stops after phase 3; ``--only-parallel`` runs
phases 1, 2 and 7e-7g alone; ``--profile`` adds, at
the end, ``torch.profiler`` breakdowns of decode steps and of verify
steps (bf16 and int8 pages; the synchronous eager loop, then the default
one with CUDA graphs) of an in-process engine, of decode steps with int8
weights (the ``qdot_int8`` kernel's share) and over the dense cache
(also with int8 weights at 8 and at 16 dense slots, 5g's short tier),
of mixed steps and of standalone prefill chunks (eager and with their graphs), the decode step
with the flight recorder on and off, and of a bench_1b training step.
Subprocess logs go to
``chiprun_out/chip_smoke_*.log``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out'

# Kernel vs plain, both fp32 accumulations over the same bf16 inputs:
# they differ only in summation order (~1e-6 on outputs of magnitude
# ~1), so 1e-3 absolute catches any indexing or masking fault.
ATOL = 1e-3

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# time_ms: the sleep ahead of each timed call, in SM clock cycles (about
# a millisecond, longer than the host takes to enqueue any timed call).
SLEEP_CYCLES = 2_000_000
# The AdamW update's leaves: BENCHMARK.json's ft stage (Mistral-7B-v0.3
# at 16 layers, bf16 params and moments, 3,758,231,552 elements), and its
# bytes an element in one pass (g, mu, nu, p read; mu, nu, p written).
ADAMW_LEAVES = {
    'embed': (32768, 4096), 'attn_norm': (16, 4096),
    'wq': (16, 4096, 4096), 'wk': (16, 4096, 1024), 'wv': (16, 4096, 1024),
    'wo': (16, 4096, 4096), 'mlp_norm': (16, 4096),
    'w_gate': (16, 4096, 14336), 'w_up': (16, 4096, 14336),
    'w_down': (16, 14336, 4096), 'final_norm': (4096,),
    'lm_head': (4096, 32768)}
ADAMW_BYTES_PER_ELEMENT = 14

# Llama-3-8B attention shapes.
HKV, GROUP, HD, PAGE = 8, 4, 128, 64
MAX_SEQ = 2048
DECODE_LENGTHS = [1, 64, 65, 2000, 512, 1023, 777, 130]
PREFILL_C, PREFILL_OFFSET, PREFILL_TRUE_LEN = 256, 192, 200
# Prefill's second case: the last chunk of a 2048-token prompt (long
# prompts, RAG contexts), where the prefix pages outweigh the chunk.
PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN = MAX_SEQ - PREFILL_C, PREFILL_C
# Speculative verify: R = spec_k + 1 = 5 queries per slot over the decode
# lengths, the last slot's run at the block table's coverage edge
# (2044 + 5 > 2048: its last queries see the whole table).
VERIFY_R = 5
VERIFY_LENGTHS = DECODE_LENGTHS[:-1] + [MAX_SEQ - 4]
# Phases 5b and 5c: 8 prompts x 64 new tokens; the oracle drafter is
# wrong at this draft index for every other prompt. The prompts and their
# tokens need 33 pages of 64 rows; phase 5c cuts the pool to POOL_CUT
# (the sink included), which holds the longest request (9 pages) but
# not all of them at once, so the engine must preempt.
SPEC_PROMPT_LENGTHS = [64, 100, 17, 300, 64, 129, 500, 200]
SPEC_NEW, ORACLE_WRONG_AT = 64, 2
# Phase 5d: the aggressor's prompt (three chunks of 256) and the new
# tokens of 5b's 17-token prompt, whose slot frees for the aggressor
# while the other seven decode.
FUSED_AGGRESSOR, FUSED_SHORT = 768, 16
# Phase 5e: a shared system block (four chunks of 256) with 16-token
# tails, 8 of them (the first alone, seeding the tree), one repeat, and a
# long unique prompt (seven chunks) beside the last seven tails. The
# cache-on engine runs over a pool of PREFIX_POOL pages (the sink
# included), which makes it preempt; the cache-off reference over the
# full pool (cut this far, it preempts thousands of times: each resume
# re-prefills a whole prompt). PREFIX_NEW keeps every request inside its
# frontier page (1040 + 40 < 1088), and every chunk of either engine, its
# resumes included, starts on a multiple of 256 or at the system block's
# end: the same chunks, so the same bits, with the cache on and off.
PREFIX_SYSTEM, PREFIX_TAIL, PREFIX_TAILS = 1024, 16, 8
PREFIX_LONG, PREFIX_NEW, PREFIX_POOL = 1792, 40, 52
POOL_CUT = 21
# Phase 5g: the dense cache (the reference server's default). Its page
# view reads whole slots: a 2048-row slot is 32 pages of 64, a slot of
# the long tier (8192 rows) a table row of 128 pages. Chunks take the
# reference's buckets (16, 64, 256) at offsets that are multiples of the
# 256-token cap: phase 3 holds the prefill kernel at C 16 and 64 and at
# the 128-page row, offsets up to the last chunk of each tier.
LONG_SEQ = 8192
DENSE_PREFILL_CASES = [  # (slot rows, C, offset, true_len)
    (MAX_SEQ, 16, 0, 16), (MAX_SEQ, 16, 1792, 11), (MAX_SEQ, 64, 1792, 50),
    (MAX_SEQ, 256, 1792, 256), (LONG_SEQ, 16, 1792, 16),
    (LONG_SEQ, 64, 7936, 64), (LONG_SEQ, 256, 7936, 256),
    (LONG_SEQ, 256, 1792, 200)]
# Decode and verify over the dense view, one identity row a length
# (slot rows, lengths): the long tier's 128-page rows at a 3,000-token
# context, the long tier's last chunk and its end, and the short tier's
# 16 slots of 32 pages. The first verify slot's run passes its row's end
# (capped there) with the next slot's pages right after it.
DENSE_SHORT_LENGTHS = [1, 16, 17, 63, 64, 65, 255, 256, 257, 1000, 1500,
                       1792, 1808, 2000, 2040, MAX_SEQ]
DENSE_DECODE_CASES = [(LONG_SEQ, [3000, 7936, LONG_SEQ]),
                      (MAX_SEQ, DENSE_SHORT_LENGTHS)]
DENSE_VERIFY_CASES = [(LONG_SEQ, [LONG_SEQ - 2, 3000, 7936]),
                      (MAX_SEQ, [MAX_SEQ - 2] + DENSE_SHORT_LENGTHS[:-1])]
# The reference's default chunk buckets, which the dense cache keeps.
DENSE_BUCKETS = (16, 64, 256)
# 5g(b): the reference's examples/serve_llm.yaml single-chip variant with
# its long-context tier (examples/serve_llm_longctx.yaml), no --paged; a
# prompt past the short tier's 2047 tokens routes to the long one.
DENSE_REPLICA = ['--model', '8b', '--quantize', '--slots', '16',
                 '--max-seq-len', str(MAX_SEQ), '--long-slots', '2',
                 '--long-seq-len', str(LONG_SEQ)]
DENSE_LONG_PROMPT = 3000
# A preempted request resumes by recomputing its K/V through prefill,
# whose products run at other shapes than the decode and verify steps'
# (so cuBLAS may round them differently): its tokens after the resume may
# part from the uncut pool's only where the uncut continuation's top-2
# logit margin is at most NEAR_TIE of the top logit.
NEAR_TIE = 1e-2

# bench_1b attention (b 6, 12 heads of 128, group 1, s 2048, causal) and
# its loss (T = 6 x 2048 tokens, d 1536, V 32768); the plain versions
# walk keys and the vocabulary in tiles of BLOCK (the bench's 512).
FB, FH, FS, FD = 6, 12, 2048, 128
CE_T, CE_D, CE_V = 6 * 2048, 1536, 32768
BLOCK = 512
# Kernel vs plain, training kernels. bf16 outputs (out, dq, dk, dv):
# both sides accumulate in fp32 and round once to bf16, so they may
# differ by one bf16 step (2^-7 relative) plus fp32 summation noise,
# allowed at 1e-3 of the tensor's largest magnitude; an indexing or
# masking fault is off by the size of the values themselves. fp32
# outputs (lse, nll): summation order only, 1e-5 relative plus 1e-5 of
# the largest magnitude.
BF16_RTOL, BF16_ATOL_FRAC = 2.0 ** -7, 1e-3
FP32_RTOL, FP32_ATOL_FRAC = 1e-5, 1e-5
# The slice vs its plain path (bf16 training step): the plain path
# rounds P to bf16 before P @ V and the logits to bf16 before the loss,
# the kernels keep both in fp32, and every other product rounds to bf16
# on both sides in another order: loss within 1e-2, each gradient leaf
# within 5e-2 by relative norm.
SLICE_LOSS_ATOL, SLICE_GRAD_RTOL = 1e-2, 5e-2
# The int8-weight product (csrc/qdot_int8.cu), [K, N] per weight: the 8B
# model's (wq and wo, wk and wv, w_gate and w_up, w_down, lm_head), an N
# that is not a multiple of the kernel's 128-column tile, and llama-350m's
# (phase 7b serves it). Row counts: a chunk's last-row logits (1), a
# ragged count (17), a decode or verify step on 8 and 16 slots (64, 128)
# and a 256-token chunk. Kernel and plain version both round the fp32
# sum to bf16 and the scaled product to bf16 again, summing in other
# orders: each rounding may land on the neighbouring bf16 value, so
# within two bf16 steps (2^-6 of the value), plus 1e-3 of the largest
# magnitude for sums that cancel.
# Tensor parallelism: a rank's Megatron slices of the 8B weights at tp 2
# (phase 5h runs them) and tp 8 (the shipped recipes' --tp 8), column
# weights split along N, row weights along K. tp 8's lm_head N 16,032 is
# not a multiple of the 128-column block, and K 512 and 1,792 change the
# K-split count.
QDOT_TP_SHAPES = {
    'tp2 wq': (4096, 2048), 'tp2 wk/wv': (4096, 512),
    'tp2 wo': (2048, 4096), 'tp2 w_gate/w_up': (4096, 7168),
    'tp2 w_down': (7168, 4096), 'tp2 lm_head': (4096, 64_128),
    'tp8 wq': (4096, 512), 'tp8 wk/wv': (4096, 128),
    'tp8 wo': (512, 4096), 'tp8 w_gate/w_up': (4096, 1792),
    'tp8 w_down': (1792, 4096), 'tp8 lm_head': (4096, 16_032)}
QDOT_SHAPES = {
    'wq/wo': (4096, 4096), 'wk/wv': (4096, 1024),
    'w_gate/w_up': (4096, 14336), 'w_down': (14336, 4096),
    'lm_head': (4096, 128_256), 'n1040': (4096, 1040),
    '350m wq/wo': (1024, 1024), '350m wk/wv': (1024, 512),
    '350m w_gate/w_up': (1024, 4096), '350m w_down': (4096, 1024),
    '350m lm_head': (1024, 32_768), **QDOT_TP_SHAPES}
QDOT_8B = ('wq/wo', 'wk/wv', 'w_gate/w_up', 'w_down', 'lm_head')
QDOT_TP2 = tuple(n for n in QDOT_TP_SHAPES if n.startswith('tp2'))
QDOT_MAIN = 'w_gate/w_up'
QDOT_ROWS = (1, 17, 64, 128, 256)
QDOT_TIMED_ROWS = (64, 256)
QDOT_RTOL, QDOT_ATOL_FRAC = 2.0 ** -6, 1e-3
# The attention kernels at a tensor-parallel rank's KV heads (group and
# head_dim unchanged): tp 2 (phase 5h) and tp 8 (the grid's head axis 8x
# smaller), over 8 dense slots of MAX_SEQ rows (32-page identity rows):
# decode and verify at these lengths, prefill at (C, offset, true_len).
TP_HKV = {2: HKV // 2, 8: HKV // 8}
TP_DECODE_LENGTHS = [1, 17, 64, 65, 257, 1000, 1792, MAX_SEQ]
TP_VERIFY_LENGTHS = [MAX_SEQ - 2, 1, 17, 64, 65, 257, 1000, 1792]
TP_PREFILL_CASES = [(16, 0, 16), (64, 1792, 50), (256, 1792, 256)]
# Phase 5h: two ranks share the one card over gloo (a correctness run:
# their collectives stage through the host), 5b's first TP_PROMPTS
# prompts x TP_NEW new tokens, spec_k 4 with the oracle drafter.
TP_PROMPTS, TP_NEW = 4, 32
TRAINING_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                    'flash_attention_bwd_dkv', 'fused_cross_entropy_fwd')
FLASH_KERNELS = TRAINING_KERNELS[:3]
# The flash kernels at a tensor-parallel training rank's heads (b, hq,
# hkv, s, d): bench_1b at tp 2 (6 of its 12 heads, group 1) and Llama-3-8B
# at tp 2 (16 query and 4 KV heads, group 4) at the fine-tuning recipe's
# seq 4096, one row.
FLASH_TP_SHAPES = {'bench_1b tp 2': (FB, FH // 2, FH // 2, FS, FD),
                   '8B tp 2': (1, 16, 4, 4096, FD)}
# Phase 7e's ring blocks: Llama-3-8B's 32 query and 8 KV heads at the
# shard of sp 2 over 8,192 rows. The diagonal block runs the causal
# kernels, the block below it the full ones (rows 5r and 6r of PERF.md's
# kernel table).
RING_B, RING_HQ, RING_HKV, RING_S, RING_SP = 1, 32, 8, 8192, 2
FLASH_RING_SHAPES = {
    f'8B ring block {causal}': ((RING_B, RING_HQ, RING_HKV,
                                 RING_S // RING_SP, FD), causal)
    for causal in (True, False)}
# Phase 6b: the remat policies' gradients against full's on the card, by
# relative norm. The same products on the same inputs in the same order
# give the same bits; only the embedding's scatter-add (atomics, three or
# more rows of one token) may round in another order.
REMAT_GRAD_RTOL = 1e-3
# Phase 7c: train.run's rank program on 4 gloo ranks sharing the card
# (llama-350m at fsdp 2 x tp 2, bf16) against the one-rank run: losses of
# ~10.9 summed over 2,048 tokens whose bf16 products round in other
# orders at the tp ranks' shapes, within MESH_LOSS_ATOL. Under train.run's
# warmup of 100 steps the first update is at lr 0 and the second at lr /
# 100, so lr 0.02 makes the second update move the step-3 loss well past
# the tolerance; the one-rank run at lr 0 (the state left as it was) is
# the control, which must part from the one-rank run by more than
# MESH_CONTROL_X times MESH_LOSS_ATOL, or the check could not see a mesh
# step that updates nothing. On an H100 (700 W) the mesh's losses came
# within 1.7e-3 of one rank's and the control parted by 6.14 (the step-3
# loss 10.90 -> 4.76).
MESH_ARGS = ['--model', 'llama-350m', '--seq', '512', '--batch', '4',
             '--steps', '3', '--log-every', '1', '--checkpoint-every', '2',
             '--lr', '0.02']
MESH_LOSS_ATOL = 1e-2
MESH_CONTROL_X = 10
# Phase 7e: ring attention vs one rank's flash attention and the plain
# ring. Both sides round to bf16 once a value; the ring merges its two
# blocks' bf16 outputs (forward) and sums their bf16 gradients (dQ, and
# dK/dV over the ring) in fp32, so it may part by two bf16 steps (2^-6
# relative) plus the merge's fp32 noise, allowed at 1e-3 of the largest
# magnitude; a wrong mask or merge is off by the size of the values.
RING_RTOL, RING_ATOL_FRAC = 2.0 ** -6, 1e-3
# Against the plain ring on the same values in fp32 (exact arithmetic
# but for fp32 order), the bf16 kernels' own rounding shows: each value
# of P, O and dS rounds once (2^-9 relative), so the outputs part by a
# few 1e-3 in relative norm. Elementwise, cancelling sums near zero part
# by more than two bf16 steps (dk 0.024 where the one-rank flash parted
# by 0.031 at its own tolerance), hence the norm.
RING_PLAIN_REL = 1e-2
# Phase 7f: bench_1b at its 24 layers over PP_STAGES stages,
# PP_MICROBATCHES microbatches of 1 x PP_SEQ; each gradient leaf within
# PP_GRAD_REL by relative norm of one rank's (bf16 products at b 1 vs b
# 4 round in other orders; the slice check's bound).
PP_STAGES, PP_MICROBATCHES, PP_SEQ = 2, 4, 2048
PP_GRAD_REL = 5e-2
# Phase 7g: Mixtral-8x7B's width at MOE_LAYERS layers, b MOE_B x s MOE_S,
# ep MOE_EP; gradient leaves within MOE_GRAD_REL by relative norm of ep
# 1's; MOE_SGD_STEPS SGD steps at MOE_SGD_LR (a bf16 weight of the head,
# about 0.016, moves by one bf16 step only past an update of 6e-5: the
# head's gradient, about 2.4e-4 an element, needs an lr near 1 to move
# the loss).
MOE_LAYERS, MOE_B, MOE_S, MOE_EP = 2, 2, 2048, 2
MOE_GRAD_REL = 5e-2
MOE_SGD_STEPS, MOE_SGD_LR = 3, 1.0
MOE_REDUCED = ('n_layers 32 -> 2: Mixtral-8x7B is 46.7 B parameters, 93 GB '
               'in bf16, more than one card holds; every width is the '
               'published one')
# The flash kernels at 7f's and 7g's attention shapes, causal (rows 5p
# and 6p of PERF.md's kernel table): bench_1b's 12 heads at one
# microbatch of 1 x PP_SEQ, and Mixtral-8x7B's 32 query and 8 KV heads at
# ep 1's b MOE_B and an ep 2 rank's b MOE_B / MOE_EP, s MOE_S.
MOE_HQ, MOE_HKV = 32, 8
FLASH_PATH_SHAPES = {
    'pp microbatch': (1, FH, FH, PP_SEQ, FD),
    'Mixtral ep 1': (MOE_B, MOE_HQ, MOE_HKV, MOE_S, FD),
    'Mixtral ep 2 rank': (MOE_B // MOE_EP, MOE_HQ, MOE_HKV, MOE_S, FD)}
# Phase 7d: run_vision's rank program at dp 2 on the card (ResNet-50, bf16)
# against one rank: the first loss before any update within 1e-2 of it,
# the later ones (after SGD on updates that rounded in bf16 in other
# orders) within VISION_LOSS_RTOL. The recipe's batch 1024 is cut to 32,
# so its lr 0.1 by the linear scaling rule to 0.003 (at 0.1 a batch of 32
# random images diverges: losses 12.7, 16.1, 228 on the card).
VISION_ARGS = ['--model', 'resnet50', '--batch', '32', '--image-size', '224',
               '--steps', '3', '--log-every', '1', '--lr', '0.003']
VISION_LOSS_RTOL = 5e-2
# --profile: decode steps with every slot at this context.
PROFILE_PROMPT, PROFILE_STEPS = 512, 20
# --profile's chunk steps: a prompt of seven 256-token chunks, timed over
# this many prompts.
PROFILE_AGGRESSOR, PROFILE_WINDOWS = 1792, 5


# Phase 2: instructions each tensor-core kernel's compiled code must
# hold (cuobjdump -sass), by source and kernel: wgmma products, TMA tile
# loads and mbarrier waits in the flash, cross-entropy and int8-weight
# kernels; mma.sync products and cp.async copies in the paged kernels.
_WGMMA_TMA = ('HGMMA', 'UTMALDG', 'SYNCS')
_MMA_CP_ASYNC = ('HMMA', 'LDGSTS')
SASS_REQUIRED = {
    'flash_fwd': (('flash_fwd_kernel', _WGMMA_TMA),),
    'flash_bwd': (('flash_bwd_dq_kernel', _WGMMA_TMA),
                  ('flash_bwd_dkv_kernel', _WGMMA_TMA)),
    'ce_fwd': (('ce_fwd_kernel', _WGMMA_TMA),),
    'paged_decode': (('paged_attention_kernel', _MMA_CP_ASYNC),),
    'paged_prefill': (('paged_prefill_kernel', _MMA_CP_ASYNC),),
    'qdot_int8': (('qdot_int8_kernel', _WGMMA_TMA),)}


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median milliseconds of the device's work for one call of ``fn``,
    by CUDA events, the L2 cache flushed (a 64 MB write) before each
    timed call. A sleep kernel (about a millisecond) enqueued before the
    start event keeps the device busy while the host enqueues the call,
    so the events time the device, not the wrapper's Python."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_sass(_build) -> None:
    """Phase 2: count the SASS_REQUIRED ops in each kernel (every
    instance: head_dim, page size, page type), from ``cuobjdump -sass``
    of its built library; fail if one is missing."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    for source, kernels in SASS_REQUIRED.items():
        sass = subprocess.run(
            [tool, '-sass', str(_build.library_path(source))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for kernel, ops in kernels:
            bodies = [body for body in sass.split('Function : ')[1:]
                      if kernel in body.split('\n', 1)[0]]
            if not bodies:
                fail(f'{source}: no compiled {kernel} in cuobjdump output')
            for body in bodies:
                name = body.split('\n', 1)[0]
                args = re.findall(r'Li(\d+)E', name) + (
                    ['int8'] if 'EaE' in name else [])
                label = f'{kernel}<{",".join(args) or "?"}>'
                counts = {op: len(re.findall(rf'\b{op}\b', body))
                          for op in ops}
                print(f'  {source}: {label} '
                      + ', '.join(f'{op} {n}' for op, n in counts.items()),
                      flush=True)
                if not all(counts.values()):
                    fail(f'{source}: {label} lacks one of {ops}: {counts}')


# ---------------------------------------------------------------------------
# Phase 3 + 4: kernels
# ---------------------------------------------------------------------------
def split_edges(pa, page):
    """Lengths at the decode/verify kernel's split edges (a split holds
    ``pa.PAGES_PER_SPLIT`` pages of ``page`` rows, E positions): one short
    of a split, a full split, one past it, and 2E - 1, whose decode at
    lengths + 1 fills two splits while its verify run opens a third."""
    edge = pa.PAGES_PER_SPLIT * page
    return [edge - 1, edge, edge + 1, 2 * edge - 1]


def variant_pages(pa):
    """Block-table width of the small variant cases: 8 pages, or three
    splits where a split holds more (room for split_edges' third)."""
    return max(8, 3 * pa.PAGES_PER_SPLIT)


def ce_split_edges(ce):
    """Vocabularies one tile short of the cross-entropy kernel's split
    edge E (one split), on it (one full split) and one tile past it (a
    second split of one tile), and E + 8 (a second split of 8 columns)."""
    edge = ce.CE_BLOCK_V * ce.CE_TILES_PER_SPLIT
    return [edge - ce.CE_BLOCK_V, edge, edge + ce.CE_BLOCK_V, edge + 8]


def prefill_split_edges(pa, page):
    """Prefix lengths (page-aligned offsets) around the prefill kernel's
    first split edge (a split holds ``pa.PREFILL_PAGES_PER_SPLIT`` pages
    of ``page`` rows, E positions): one page short of it, on it, one
    page past it."""
    edge = pa.PREFILL_PAGES_PER_SPLIT * page
    return [edge - page, edge, edge + page]


def prefill_pages(pa):
    """Block-table width of the small prefill variant cases: room for a
    4-page chunk past the last of prefill_split_edges."""
    return max(8, pa.PREFILL_PAGES_PER_SPLIT + 5)


def decode_case(torch, gen, lengths, hkv, group, hd, page, maxp):
    slots = len(lengths)
    need = sum(-(-n // page) for n in lengths)
    n_pages = need + 9
    dev = 'cuda'
    ids = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
    tables = torch.zeros((slots, maxp), dtype=torch.int32, device=dev)
    i = 0
    for b, n in enumerate(lengths):
        k = -(-n // page)
        tables[b, :k] = ids[i:i + k].to(torch.int32)
        i += k
    shape = (hkv, n_pages, page, hd)
    k_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((slots, hkv, group, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pages, v_pages, tables, lengths


def prefill_case(torch, gen, C, hkv, group, hd, page, maxp):
    n_pages = maxp + 8
    dev = 'cuda'
    row = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:maxp]
           + 1).to(torch.int32)
    shape = (hkv, n_pages, page, hd)
    k_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((C, hkv, group, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    return q, k_pages, v_pages, row


def verify_case(torch, gen, lengths, R, hkv, group, hd, page, maxp):
    """R queries per slot; each slot's table covers its run, up to the
    table's coverage."""
    cover = [min(n + R, maxp * page) for n in lengths]
    _, k_pages, v_pages, tables, _ = decode_case(torch, gen, cover, hkv,
                                                 group, hd, page, maxp)
    q = torch.randn((len(lengths), R, hkv, group, hd), generator=gen,
                    device='cuda').to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return q, k_pages, v_pages, tables, lengths


def quantize_case(pa, case):
    """The same case on int8 pages, values and scales from
    ``quantize_rows`` of its bf16 pages: (case, scale keywords)."""
    q, k_pages, v_pages, *rest = case
    kq, ks = pa.quantize_rows(k_pages)
    vq, vs = pa.quantize_rows(v_pages)
    return (q, kq, vq, *rest), {'k_scales': ks, 'v_scales': vs}


def decode_err(torch, pa, case, **kw) -> float:
    out = pa.paged_decode_attention(*case, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_decode: non-finite output')
    ref = pa.paged_decode_attention_reference(*case, **kw)
    return (out - ref).abs().max().item()


# Prefill cases whose device-scalar entry was held bitwise to the host-
# scalar entry (phase 3), by page type.
DEVICE_SCALAR_CHECKS = {'bf16': 0, 'int8': 0}


def device_scalars(torch, offset: int, true_len: int):
    """offset and true_len as the engine passes them: 0-d int32 tensors
    on the card, views of one staged buffer."""
    meta = torch.tensor([offset, true_len], dtype=torch.int32, device='cuda')
    return meta[0], meta[1]


def prefill_err(torch, pa, case, offset, true_len, **kw) -> float:
    """Max abs error of the prefill kernel's rows below true_len; fails
    unless every row, pad rows too, is finite (the model writes pad rows
    back into the pages), and unless the device-scalar entry (offset and
    true_len read on the card, a grid over the whole table row) gives
    the host-scalar entry's output bit for bit."""
    out = pa.paged_prefill_attention(*case, offset, true_len, **kw)
    dev = pa.paged_prefill_attention(
        *case, *device_scalars(torch, offset, true_len), **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_prefill: non-finite output')
    if not torch.equal(out, dev):
        fail(f'paged_prefill: the device-scalar entry is not bitwise the '
             f'host-scalar entry at offset {offset}, true_len {true_len}, '
             f'q {tuple(case[0].shape)}, pages {tuple(case[1].shape)}, '
             f'int8 {bool(kw)}: max diff {(out - dev).abs().max().item()}')
    DEVICE_SCALAR_CHECKS['int8' if kw else 'bf16'] += 1
    ref = pa.paged_prefill_attention_reference(*case, offset, true_len, **kw)
    return (out[:true_len] - ref[:true_len]).abs().max().item()


def verify_err(torch, pa, case, **kw) -> float:
    """The verify kernel against its plain version; fails unless every
    slot's query i is bitwise the decode kernel's output at lengths + i +
    1 (capped at the block table's coverage), for every i: the
    exact-greedy acceptance rule rests on query 0, and speculation's
    tokens equal speculation-off's bit for bit only if every query
    is."""
    q, k_pages, v_pages, tables, lengths = case
    out = pa.paged_verify_attention(*case, **kw)
    cover = tables.shape[1] * k_pages.shape[2]
    decs = [pa.paged_decode_attention(
        q[:, i].contiguous(), k_pages, v_pages, tables,
        torch.clamp(lengths + i + 1, max=cover), **kw)
        for i in range(q.shape[1])]
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_verify: non-finite output')
    for i, dec in enumerate(decs):
        if not torch.equal(out[:, i], dec):
            rows = [b for b in range(q.shape[0])
                    if not torch.equal(out[b, i], dec[b])]
            fail(f'paged_verify: query {i} is not bitwise the decode kernel '
                 f'at lengths + {i + 1}: rows {rows}, R {q.shape[1]}, '
                 f'lengths {lengths[rows].tolist()}, max diff '
                 f'{(out[:, i] - dec).abs().max().item()}, shape '
                 f'{tuple(q.shape)}, int8 {bool(kw)}')
    ref = pa.paged_verify_attention_reference(*case, **kw)
    return (out - ref).abs().max().item()


def check_kernels(torch, pa):
    """Phase 3: each kernel against its plain version at the 8B shapes,
    then at every shape the kernels take (``pa.CUDA_HEAD_DIMS`` x
    ``CUDA_GROUPS`` x ``CUDA_PAGE_SIZES``, the shapes of the other model
    presets and page sizes among them) on small inputs. Returns {name:
    (max_abs_err at the 8B shapes, inputs)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    results = {}
    dcase = decode_case(torch, gen, DECODE_LENGTHS, HKV, GROUP, HD, PAGE,
                        MAX_SEQ // PAGE)
    err = decode_err(torch, pa, dcase)
    print(f'paged_decode vs plain: max_abs_err={err:.3e} (atol {ATOL}) '
          f'lengths={DECODE_LENGTHS}', flush=True)
    if err > ATOL:
        fail(f'paged_decode disagrees with its plain version: {err}')
    results['paged_decode'] = (err, dcase)

    tl = PREFILL_TRUE_LEN
    pcase = prefill_case(torch, gen, PREFILL_C, HKV, GROUP, HD, PAGE,
                         MAX_SEQ // PAGE)
    err = prefill_err(torch, pa, pcase, PREFILL_OFFSET, tl)
    print(f'paged_prefill vs plain: max_abs_err={err:.3e} (atol {ATOL}) '
          f'C={PREFILL_C} offset={PREFILL_OFFSET} true_len={tl}',
          flush=True)
    if err > ATOL:
        fail(f'paged_prefill disagrees with its plain version: {err}')
    results['paged_prefill'] = (err, pcase)
    worst = 0.0
    cases = [(off, tl) for off in prefill_split_edges(pa, PAGE)]
    for off, n in cases + [(PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN)]:
        worst = max(worst, prefill_err(torch, pa, pcase, off, n))
    print(f'paged_prefill vs plain at offsets {prefill_split_edges(pa, PAGE)}'
          f' (split edges, {pa.PREFILL_PAGES_PER_SPLIT} pages a split) and '
          f'{PREFILL_LONG_OFFSET} (true_len {PREFILL_LONG_TRUE_LEN}): '
          f'max_abs_err={worst:.3e} (atol {ATOL})', flush=True)
    if worst > ATOL:
        fail(f'paged_prefill disagrees with its plain version at the split '
             f'edges or the long prefix: {worst}')
    # Pages past the frontier hold the pad rows the model writes back:
    # NaN there (the rest of the frontier's page and the page after it)
    # must not change a bit of the output.
    q, kp, vp, row = pcase
    total = PREFILL_OFFSET + tl
    clean = pa.paged_prefill_attention(*pcase, PREFILL_OFFSET, tl)
    poisoned = []
    for p in (kp, vp):
        p = p.clone()
        p[:, row[total // PAGE].long(), total % PAGE:] = float('nan')
        p[:, row[total // PAGE + 1].long()] = float('nan')
        poisoned.append(p)
    out = pa.paged_prefill_attention(q, *poisoned, row, PREFILL_OFFSET, tl)
    dev = pa.paged_prefill_attention(q, *poisoned, row, *device_scalars(
        torch, PREFILL_OFFSET, tl))
    if not (torch.equal(out, clean) and torch.equal(dev, clean)):
        fail('paged_prefill: NaN in K/V rows past the frontier changed the '
             'output')
    print('paged_prefill: NaN K/V past the frontier leaves the output '
          'bitwise unchanged (host- and device-scalar entries)', flush=True)

    # Every variant: lengths of 1, a page, a page + 1 and a few pages;
    # a 4-page chunk at a 3-page offset (page- but not chunk-aligned)
    # and at the prefill split edges, with true_len < C.
    worst = {'paged_decode': 0.0, 'paged_prefill': 0.0}
    n = 0
    for hd in pa.CUDA_HEAD_DIMS:
        for group in pa.CUDA_GROUPS:
            for page in pa.CUDA_PAGE_SIZES:
                shape = f'hd={hd} group={group} page={page}'
                case = decode_case(torch, gen, [1, page, page + 1,
                                                5 * page - 3]
                                   + split_edges(pa, page),
                                   2, group, hd, page, variant_pages(pa))
                err = decode_err(torch, pa, case)
                if err > ATOL:
                    fail(f'paged_decode disagrees with its plain version '
                         f'at {shape}: {err}')
                worst['paged_decode'] = max(worst['paged_decode'], err)
                case = prefill_case(torch, gen, 4 * page, 2, group, hd,
                                    page, prefill_pages(pa))
                err = max(prefill_err(torch, pa, case, off, 4 * page - 5)
                          for off in [3 * page]
                          + prefill_split_edges(pa, page))
                if err > ATOL:
                    fail(f'paged_prefill disagrees with its plain version '
                         f'at {shape}: {err}')
                worst['paged_prefill'] = max(worst['paged_prefill'], err)
                n += 1
    print(f'all {n} kernel shapes vs plain: max_abs_err decode '
          f'{worst["paged_decode"]:.3e}, prefill '
          f'{worst["paged_prefill"]:.3e} (atol {ATOL})', flush=True)
    return results


def dense_prefill_case(torch, gen, rows, C, hkv=HKV):
    """A prefill case over the dense cache's page view at the 8B shapes
    (``hkv`` KV heads: a tensor-parallel rank's share): two slots of
    ``rows`` rows in pages of PAGE, the chunk in slot 1, whose identity
    row lists pages rows / PAGE .. 2 rows / PAGE - 1."""
    per = rows // PAGE
    shape = (hkv, 2 * per, PAGE, HD)
    k_pages = torch.randn(shape, generator=gen, device='cuda').to(
        torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device='cuda').to(
        torch.bfloat16)
    q = torch.randn((C, hkv, GROUP, HD), generator=gen, device='cuda').to(
        torch.bfloat16)
    row = torch.arange(per, 2 * per, dtype=torch.int32, device='cuda')
    return q, k_pages, v_pages, row


def check_dense_prefill(torch, pa):
    """Phase 3 for the dense cache's chunks (``DENSE_PREFILL_CASES``): the
    prefill kernel at C 16 and 64 (the reference's small buckets, which
    the paged ladder never launches) and 256, over 32-page and 128-page
    identity rows, offsets up to the last chunk of each tier; each
    against its plain version and its device-scalar entry bitwise the
    host-scalar one (``prefill_err``). Returns the C-16 case and the
    128-page case for phase 4, as {name: (max_abs_err, inputs, offset,
    true_len)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(5)
    worst, out = 0.0, {}
    for rows, C, off, tl in DENSE_PREFILL_CASES:
        case = dense_prefill_case(torch, gen, rows, C)
        err = prefill_err(torch, pa, case, off, tl)
        if err > ATOL:
            fail(f'paged_prefill disagrees with its plain version over the '
                 f'dense view: rows {rows}, C {C}, offset {off}, true_len '
                 f'{tl}: {err}')
        worst = max(worst, err)
        if (rows, C, off) == (MAX_SEQ, 16, 1792):
            out['paged_prefill_c16'] = (err, case, off, C)
        if (rows, C, off) == (LONG_SEQ, 256, 7936):
            out['paged_prefill_128p'] = (err, case, off, tl)
    print(f'paged_prefill vs plain over the dense view (identity rows of '
          f'{MAX_SEQ // PAGE} and {LONG_SEQ // PAGE} pages; (rows, C, '
          f'offset, true_len) {DENSE_PREFILL_CASES}): max_abs_err='
          f'{worst:.3e} (atol {ATOL}); device-scalar entry bitwise',
          flush=True)
    return out


def dense_attention_case(torch, gen, lengths, rows, R=0, hkv=HKV):
    """A decode (R 0) or verify (R queries a slot) case over the dense
    cache's page view at the 8B shapes (``hkv`` KV heads): a slot of
    ``rows`` rows in pages of PAGE per length, its table the slot's
    identity row."""
    from skypilot_tpu_torch.infer import cache as cache_lib
    slots = len(lengths)
    shape = (hkv, slots * rows // PAGE, PAGE, HD)
    k_pages = torch.randn(shape, generator=gen, device='cuda').to(
        torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device='cuda').to(
        torch.bfloat16)
    qshape = (slots,) + ((R,) if R else ()) + (hkv, GROUP, HD)
    q = torch.randn(qshape, generator=gen, device='cuda').to(torch.bfloat16)
    tables = cache_lib.identity_tables(slots, rows, PAGE, 'cuda')
    lengths = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return q, k_pages, v_pages, tables, lengths


def check_dense_attention(torch, pa) -> None:
    """Phase 3 for the dense cache's decode and verify steps
    (``DENSE_DECODE_CASES``, ``DENSE_VERIFY_CASES``): each kernel over
    identity rows against its plain version at ATOL, and every verify
    query bitwise the decode kernel at lengths + i + 1 (``verify_err``)."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(6)
    worst = {'paged_decode': 0.0, 'paged_verify': 0.0}
    for name, cases, R, err_of in (
            ('paged_decode', DENSE_DECODE_CASES, 0, decode_err),
            ('paged_verify', DENSE_VERIFY_CASES, VERIFY_R, verify_err)):
        for rows, lengths in cases:
            err = err_of(torch, pa, dense_attention_case(torch, gen, lengths,
                                                         rows, R))
            if err > ATOL:
                fail(f'{name} disagrees with its plain version over the '
                     f'dense view: {len(lengths)} rows of {rows // PAGE} '
                     f'pages, lengths {lengths}: {err}')
            worst[name] = max(worst[name], err)
    print(f'paged_decode and paged_verify (R {VERIFY_R}) vs plain over the '
          f'dense view (identity rows; decode (rows, lengths) '
          f'{DENSE_DECODE_CASES}, verify {DENSE_VERIFY_CASES}): max_abs_err '
          f'decode {worst["paged_decode"]:.3e}, verify '
          f'{worst["paged_verify"]:.3e} (atol {ATOL}); every verify query '
          f'bitwise decode', flush=True)


def check_tp_attention(torch, pa):
    """Phase 3 at a tensor-parallel rank's KV heads (``TP_HKV``: 4 at tp
    2, 1 at tp 8; group and head_dim as the 8B model's) over 8 dense
    slots of 32-page identity rows: decode at TP_DECODE_LENGTHS, verify
    (R VERIFY_R, every query bitwise decode) at TP_VERIFY_LENGTHS, and
    the prefill kernel at TP_PREFILL_CASES, its device-scalar entry
    bitwise the host-scalar one; each against its plain version at ATOL.
    Returns tp 2's cases for phase 4 as {name: (max_abs_err, inputs[,
    offset, true_len])}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(7)
    out, worst = {}, {}
    for tp, hkv in TP_HKV.items():
        dcase = dense_attention_case(torch, gen, TP_DECODE_LENGTHS, MAX_SEQ,
                                     hkv=hkv)
        vcase = dense_attention_case(torch, gen, TP_VERIFY_LENGTHS, MAX_SEQ,
                                     VERIFY_R, hkv=hkv)
        errs = {'paged_decode': decode_err(torch, pa, dcase),
                'paged_verify': verify_err(torch, pa, vcase)}
        pcases = {}
        for C, off, tl in TP_PREFILL_CASES:
            case = dense_prefill_case(torch, gen, MAX_SEQ, C, hkv=hkv)
            err = prefill_err(torch, pa, case, off, tl)
            errs['paged_prefill'] = max(errs.get('paged_prefill', 0.0), err)
            pcases[C] = (err, case, off, tl)
        for name, err in errs.items():
            if err > ATOL:
                fail(f'{name} disagrees with its plain version at tp {tp} '
                     f'({hkv} KV heads): {err}')
        worst[tp] = errs
        if tp == 2:
            out = {'paged_decode_tp2': (errs['paged_decode'], dcase),
                   'paged_verify_tp2': (errs['paged_verify'], vcase),
                   'paged_prefill_tp2': pcases[256]}
    print(f'paged kernels vs plain at a tp rank\'s KV heads {TP_HKV} (group '
          f'{GROUP}, 8 dense slots of {MAX_SEQ // PAGE} pages; decode at '
          f'{TP_DECODE_LENGTHS}, verify R {VERIFY_R} at {TP_VERIFY_LENGTHS}, '
          f'prefill (C, offset, true_len) {TP_PREFILL_CASES}): max_abs_err '
          + json.dumps({f'tp{tp}': {k: f'{v:.3e}' for k, v in e.items()}
                        for tp, e in worst.items()})
          + f' (atol {ATOL}); every verify query bitwise decode, the '
          f'device-scalar prefill entry bitwise the host one', flush=True)
    return out


def time_attention(torch, pa, case, flush):
    """Phase 4, a decode (4-D q) or verify (5-D q) case at any KV-head
    count: the kernel, its plain version, SDPA over the K/V gathered to
    the longest needed row (a boolean mask, causal for verify) and the
    bound (q in, fp32 out, each live K/V row once, the owned table
    entries and the lengths)."""
    q, kp, vp, tables, lengths = case
    R = q.shape[1] if q.dim() == 5 else 0
    slots, hkv, group = q.shape[0], q.shape[-3], q.shape[-2]
    hq = hkv * group
    fn = pa.paged_verify_attention if R else pa.paged_decode_attention
    ref = (pa.paged_verify_attention_reference if R
           else pa.paged_decode_attention_reference)
    ms = time_ms(torch, lambda: fn(*case), 50, flush)
    plain = time_ms(torch, lambda: ref(*case), 10, flush)
    cov = tables.shape[1] * PAGE
    lens = lengths.tolist()
    need = [min(n + R, cov) for n in lens] if R else lens
    S = -(-max(need) // PAGE) * PAGE
    idx = tables[:, :S // PAGE].long()
    kg, vg = (p[:, idx].permute(1, 0, 2, 3, 4).reshape(slots, hkv, S, HD)
              for p in (kp, vp))
    if R:
        qs = q.permute(0, 2, 3, 1, 4).reshape(slots, hq, R, HD)
        horizon = (lengths.long()[:, None]
                   + torch.arange(R, device='cuda')[None, :] + 1)
        mask = (torch.arange(S, device='cuda')[None, None, :]
                < horizon[:, :, None])[:, None]
        flops = 4 * hq * HD * sum(min(n + i + 1, cov) for n in lens
                                  for i in range(R))
    else:
        qs = q.reshape(slots, hq, 1, HD)
        mask = (torch.arange(S, device='cuda')[None, :]
                < lengths[:, None].long())[:, None, None, :]
        flops = 4 * hq * HD * sum(lens)
    lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50, flush)
    n_bytes = (q.numel() * (2 + 4) + sum(need) * hkv * HD * 2 * 2
               + sum(-(-n // PAGE) for n in need) * 4 + slots * 4)
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound=bound(n_bytes, flops))


def time_tp_attention(torch, pa, tp_checked):
    """Phase 4 at tp 2's shapes (4 KV heads): decode, verify and the
    256-token chunk at offset 1792 (its host- and device-scalar
    entries)."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {name: time_attention(torch, pa, tp_checked[name][1], flush)
            for name in ('paged_decode_tp2', 'paged_verify_tp2')}
    _, case, off, tl = tp_checked['paged_prefill_tp2']
    rows['paged_prefill_tp2'] = time_prefill(torch, pa, case, {}, off, tl,
                                             flush)
    print(f'timing at tp 2\'s shapes ({TP_HKV[2]} KV heads; ' + card_line()
          + '):', flush=True)
    print_timed(rows)
    return rows


def check_spec_int8_kernels(torch, pa):
    """Phase 3 for the verify kernel and the int8 flavors: at the 8B
    shapes, then at every head_dim x group x page size (x query count for
    verify) the wrappers take, int8 pages and scales quantized from random
    bf16 rows. Returns {name: (max_abs_err at the 8B shapes, inputs, scale
    keywords)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    maxp = MAX_SEQ // PAGE
    vcase = verify_case(torch, gen, VERIFY_LENGTHS, VERIFY_R, HKV, GROUP, HD,
                        PAGE, maxp)
    dcase = decode_case(torch, gen, DECODE_LENGTHS, HKV, GROUP, HD, PAGE,
                        maxp)
    pcase = prefill_case(torch, gen, PREFILL_C, HKV, GROUP, HD, PAGE, maxp)
    off, tl = PREFILL_OFFSET, PREFILL_TRUE_LEN
    runs = {
        'paged_verify': lambda c, kw: verify_err(torch, pa, c, **kw),
        'paged_decode': lambda c, kw: decode_err(torch, pa, c, **kw),
        'paged_prefill': lambda c, kw: prefill_err(torch, pa, c, off, tl,
                                                   **kw),
    }
    results = {}
    for name, case in (('paged_verify', vcase), ('paged_verify_int8', vcase),
                       ('paged_decode_int8', dcase),
                       ('paged_prefill_int8', pcase)):
        kw = {}
        if name.endswith('_int8'):
            case, kw = quantize_case(pa, case)
        err = runs[name.replace('_int8', '')](case, kw)
        print(f'{name} vs plain at the 8B shapes: max_abs_err={err:.3e} '
              f'(atol {ATOL})' + (f', R={VERIFY_R} lengths={VERIFY_LENGTHS}, '
                                  f'every query i bitwise = decode at '
                                  f'lengths + i + 1'
                                  if 'verify' in name else ''), flush=True)
        if err > ATOL:
            fail(f'{name} disagrees with its plain version: {err}')
        results[name] = (err, case, kw)

    # The split edges at the 8B shapes, decode and verify, bf16 and int8;
    # int8 prefill at the prefill split edges and the long prefix.
    worst = max(prefill_err(torch, pa, results['paged_prefill_int8'][1], off,
                            n, **results['paged_prefill_int8'][2])
                for off, n in [(e, tl) for e in prefill_split_edges(pa, PAGE)]
                + [(PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN)])
    if worst > ATOL:
        fail(f'paged_prefill_int8 disagrees with its plain version at the '
             f'split edges or the long prefix: {worst}')
    print(f'paged_prefill_int8 vs plain at the split edges and the long '
          f'prefix: max_abs_err={worst:.3e} (atol {ATOL})', flush=True)
    edges = split_edges(pa, PAGE)
    worst = 0.0
    for name, case in (
            ('paged_decode', decode_case(torch, gen, edges, HKV, GROUP, HD,
                                         PAGE, maxp)),
            ('paged_verify', verify_case(torch, gen, edges, VERIFY_R, HKV,
                                         GROUP, HD, PAGE, maxp))):
        for c, kw in ((case, {}), quantize_case(pa, case)):
            err = runs[name](c, kw)
            if err > ATOL:
                fail(f'{name} disagrees with its plain version at the split '
                     f'edges {edges} (int8 {bool(kw)}): {err}')
            worst = max(worst, err)
    print(f'paged_decode and paged_verify (bf16, int8) vs plain at the split '
          f'edges {edges} (8B shapes, {pa.PAGES_PER_SPLIT} pages a split): '
          f'max_abs_err={worst:.3e} (atol {ATOL}), every verify query i '
          f'bitwise = decode at lengths + i + 1',
          flush=True)

    # Every variant: verify at every query count from an empty slot to a
    # run at the coverage edge (maxp * page - 3 + R > maxp * page for R >=
    # 4) and at the split edges; int8 decode and prefill at the lengths
    # and chunk of check_kernels.
    worst, n = {}, 0
    maxp = variant_pages(pa)
    for hd in pa.CUDA_HEAD_DIMS:
        for group in pa.CUDA_GROUPS:
            for page in pa.CUDA_PAGE_SIZES:
                cases = [('paged_decode', decode_case(
                    torch, gen, [1, page, page + 1, 5 * page - 3]
                    + split_edges(pa, page), 2, group, hd, page, maxp)),
                    ('paged_prefill', prefill_case(
                        torch, gen, 4 * page, 2, group, hd, page,
                        prefill_pages(pa)))]
                cases += [('paged_verify', verify_case(
                    torch, gen, [0, page - 2, 5 * page - 3, maxp * page - 3]
                    + split_edges(pa, page), R, 2, group, hd, page, maxp))
                    for R in pa.CUDA_VERIFY_QUERIES
                    if R * group <= pa.CUDA_MAX_ROWS]
                for name, case in cases:
                    flavors = [('_int8', *quantize_case(pa, case))]
                    if name == 'paged_verify':
                        flavors.append(('', case, {}))
                    for suffix, c, kw in flavors:
                        if name == 'paged_prefill':
                            err = max(prefill_err(torch, pa, c, off,
                                                  4 * page - 5, **kw)
                                      for off in [3 * page]
                                      + prefill_split_edges(pa, page))
                        else:
                            err = runs[name](c, kw)
                        key = name + suffix
                        if err > ATOL:
                            fail(f'{key} disagrees with its plain version at '
                                 f'hd={hd} group={group} page={page} '
                                 f'q={tuple(c[0].shape)}: {err}')
                        worst[key] = max(worst.get(key, 0.0), err)
                        n += 1
    print(f'all {n} verify / int8 kernel variants vs plain (every verify '
          f'run\'s query i bitwise = decode at lengths + i + 1): '
          f'max_abs_err '
          + ', '.join(f'{k} {v:.3e}' for k, v in sorted(worst.items()))
          + f' (atol {ATOL})', flush=True)
    return results


def sdpa(torch, q, k, v, mask):
    """One library call computing the same attention (GQA by
    ``enable_gqa``)."""
    F = torch.nn.functional
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def dequantized(torch, k_pages, v_pages, kw):
    """bf16 K/V pages as the int8 flavor's plain version sees them
    (values x row scales), or the bf16 pages as they are."""
    if not kw:
        return k_pages, v_pages
    return tuple((p.float() * s[..., None]).to(torch.bfloat16)
                 for p, s in ((k_pages, kw['k_scales']),
                              (v_pages, kw['v_scales'])))


def time_prefill(torch, pa, case, kw, off, tl, flush):
    """Phase 4, one prefill case at the 8B shapes (int8 with ``kw``'s
    scales): the kernel, its device-scalar entry (``dev_ms``: offset and
    true_len read on the card, a grid over the whole table row, as the
    engine's chunk graphs launch it), its plain version, and SDPA over
    the gathered (dequantized) K/V with a boolean causal mask."""
    q, kp, vp, row = case
    C, hkv = q.shape[0], q.shape[1]
    hq = hkv * q.shape[2]
    ms = time_ms(torch, lambda: pa.paged_prefill_attention(
        *case, off, tl, **kw), 50, flush)
    scalars = device_scalars(torch, off, tl)
    dev_ms = time_ms(torch, lambda: pa.paged_prefill_attention(
        *case, *scalars, **kw), 50, flush)
    plain = time_ms(torch, lambda: pa.paged_prefill_attention_reference(
        *case, off, tl, **kw), 10, flush)
    S = off + C
    kd, vd = dequantized(torch, kp, vp, kw)
    npg = -(-S // PAGE)
    idx = row[:npg].long()
    kg = kd[:, idx].reshape(1, hkv, npg * PAGE, HD)[:, :, :S].contiguous()
    vg = vd[:, idx].reshape(1, hkv, npg * PAGE, HD)[:, :, :S].contiguous()
    qs = q.reshape(C, hq, HD).permute(1, 0, 2)[None].contiguous()
    mask = (torch.arange(S, device='cuda')[None, :]
            <= off + torch.arange(C, device='cuda')[:, None])
    lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50, flush)
    # Rows past true_len are pad the caller drops: q and the fp32 output
    # count at true_len rows, K/V at every live position once, and the
    # table entries up to the last live page.
    row_bytes = HD * 2 if not kw else HD + 4
    n_bytes = (tl * hq * HD * (2 + 4) + (off + tl) * hkv * row_bytes * 2
               + -(-(off + tl) // PAGE) * 4)
    flops = 4 * HD * hq * sum(off + c + 1 for c in range(tl))
    return dict(ms=ms, dev_ms=dev_ms, plain_ms=plain, library_ms=lib,
                bound=bound(n_bytes, flops))


def print_timed(rows) -> None:
    for name, r in rows.items():
        dev = (f', device-scalar entry {r["dev_ms"]:.4f} ms'
               if 'dev_ms' in r else '')
        print(f'{name}: {r["ms"]:.4f} ms{dev}, plain {r["plain_ms"]:.4f} ms, '
              f'library {r["library_ms"]:.4f} ms, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})', flush=True)


def time_kernels(torch, pa, checked):
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    hq = HKV * GROUP

    q, kp, vp, tables, lengths = checked['paged_decode'][1]
    slots = q.shape[0]
    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lengths), 50, flush)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_reference(
        q, kp, vp, tables, lengths), 10, flush)
    # Library yardstick: K/V gathered per slot to the longest length.
    S = max(DECODE_LENGTHS)
    S = -(-S // PAGE) * PAGE
    idx = tables[:, :S // PAGE].long()
    kg = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(slots, HKV, S, HD)
    vg = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(slots, HKV, S, HD)
    qs = q.reshape(slots, hq, 1, HD)
    mask = (torch.arange(S, device='cuda')[None, :]
            < lengths[:, None].long())[:, None, None, :]
    lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50, flush)
    # Bytes the function needs: q in, fp32 out, each live K/V row once,
    # the owned table entries and the lengths.
    toks = sum(DECODE_LENGTHS)
    owned = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    n_bytes = (q.numel() * (2 + 4) + toks * HKV * HD * 2 * 2
               + owned * 4 + lengths.numel() * 4)
    flops = 4 * toks * hq * HD
    rows['paged_decode'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound=bound(n_bytes, flops))

    case = checked['paged_prefill'][1]
    rows['paged_prefill'] = time_prefill(
        torch, pa, case, {}, PREFILL_OFFSET, PREFILL_TRUE_LEN, flush)
    rows['paged_prefill_long'] = time_prefill(
        torch, pa, case, {}, PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN,
        flush)
    print_timed(rows)
    return rows


def time_spec_int8_kernels(torch, pa, checked):
    """Phase 4 for the verify kernel and the int8 flavors at the 8B
    shapes. The library yardstick is ``scaled_dot_product_attention``
    over the gathered K/V (dequantized to bf16 beforehand for int8), with
    a boolean causal mask for verify."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    hq = HKV * GROUP
    cov = MAX_SEQ

    def gathered(k_pages, v_pages, tables, S):
        idx = tables[:, :S // PAGE].long()
        slots = tables.shape[0]
        return tuple(p[:, idx].permute(1, 0, 2, 3, 4).reshape(
            slots, HKV, S, HD) for p in (k_pages, v_pages))

    for name in ('paged_verify', 'paged_verify_int8'):
        _, case, kw = checked[name]
        q, kp, vp, tables, lengths = case
        slots, R = q.shape[:2]
        ms = time_ms(torch, lambda: pa.paged_verify_attention(*case, **kw),
                     50, flush)
        plain = time_ms(torch, lambda: pa.paged_verify_attention_reference(
            *case, **kw), 10, flush)
        S = -(-min(max(VERIFY_LENGTHS) + R, cov) // PAGE) * PAGE
        kg, vg = gathered(*dequantized(torch, kp, vp, kw), tables, S)
        qs = q.permute(0, 2, 3, 1, 4).reshape(slots, hq, R, HD)
        horizon = (lengths.long()[:, None]
                   + torch.arange(R, device='cuda')[None, :] + 1)
        mask = (torch.arange(S, device='cuda')[None, None, :]
                < horizon[:, :, None])[:, None]
        lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50,
                      flush)
        # Each slot needs its rows up to its last query's horizon, once;
        # each query row pairs with the positions it sees.
        need = [min(n + R, cov) for n in VERIFY_LENGTHS]
        row_bytes = HD * 2 if not kw else HD + 4
        n_bytes = (q.numel() * (2 + 4) + sum(need) * HKV * row_bytes * 2
                   + sum(-(-n // PAGE) for n in need) * 4 + slots * 4)
        flops = 4 * hq * HD * sum(min(n + i + 1, cov)
                                  for n in VERIFY_LENGTHS for i in range(R))
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound=bound(n_bytes, flops))

    _, case, kw = checked['paged_decode_int8']
    q, kp, vp, tables, lengths = case
    slots = q.shape[0]
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*case, **kw), 50,
                 flush)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_reference(
        *case, **kw), 10, flush)
    S = -(-max(DECODE_LENGTHS) // PAGE) * PAGE
    kg, vg = gathered(*dequantized(torch, kp, vp, kw), tables, S)
    mask = (torch.arange(S, device='cuda')[None, :]
            < lengths[:, None].long())[:, None, None, :]
    lib = time_ms(torch, lambda: sdpa(torch, q.reshape(slots, hq, 1, HD), kg,
                                      vg, mask), 50, flush)
    toks = sum(DECODE_LENGTHS)
    n_bytes = (q.numel() * (2 + 4) + toks * HKV * (HD + 4) * 2
               + sum(-(-n // PAGE) for n in DECODE_LENGTHS) * 4 + slots * 4)
    rows['paged_decode_int8'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                     bound=bound(n_bytes, 4 * toks * hq * HD))

    _, case, kw = checked['paged_prefill_int8']
    rows['paged_prefill_int8'] = time_prefill(
        torch, pa, case, kw, PREFILL_OFFSET, PREFILL_TRUE_LEN, flush)
    rows['paged_prefill_int8_long'] = time_prefill(
        torch, pa, case, kw, PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN,
        flush)
    print_timed(rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 3 + 4, the int8-weight product
# ---------------------------------------------------------------------------
def qdot_case(torch, quant, gen, k: int, n: int):
    """A [k, n] weight quantized on the card (bf16 normal draws at the
    model's init scale) and QDOT_ROWS[-1] bf16 rows of x."""
    w = quant.quantize_weight((torch.randn((k, n), generator=gen,
                                           device='cuda')
                               * k ** -0.5).to(torch.bfloat16))
    x = torch.randn((max(QDOT_ROWS), k), generator=gen,
                    device='cuda').to(torch.bfloat16)
    return x, w


def check_qdot_kernel(torch, quant):
    """Phase 3, the int8-weight product: at every weight shape of the 8B
    and 350m models and at an N off the 128-column tile, at every row
    count of QDOT_ROWS, against its plain version (QDOT_RTOL,
    QDOT_ATOL_FRAC); every row bitwise the same row of the largest
    product (a row's bits may not depend on the row count), also through
    a 1-D and a 3-D x. Returns {'qdot_int8': (max abs error at the
    w_gate shape,)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    bad, worst = [], 0.0
    for name, (k, n) in QDOT_SHAPES.items():
        x, w = qdot_case(torch, quant, gen, k, n)
        full = quant.qdot(x, w)
        errs = []
        for m in QDOT_ROWS:
            got = quant.qdot(x[:m], w)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, quant.qdot_reference(x[:m], w),
                              QDOT_RTOL, QDOT_ATOL_FRAC)
            errs.append(err)
            if not ok:
                bad.append(f'{name} M {m}: max abs error {err:.3e}')
            if not torch.equal(got, full[:m]):
                bad.append(f'{name} M {m}: rows differ from the same rows '
                           f'at M {len(x)}')
        if not torch.equal(quant.qdot(x[0], w), full[0]) \
                or not torch.equal(quant.qdot(x[:64].view(8, 8, k), w),
                                   full[:64].view(8, 8, n)):
            bad.append(f'{name}: a 1-D or 3-D x gave other bits')
        print(f'qdot_int8 vs plain at {name} [K {k}, N {n}] '
              f'({quant.cuda_splits(k, n)} K-splits), M {list(QDOT_ROWS)}: '
              + ', '.join(f'{e:.3e}' for e in errs)
              + f' (rtol 2^-6 + {QDOT_ATOL_FRAC} x max); rows bitwise '
              f'across M', flush=True)
        if name == QDOT_MAIN:
            worst = max(errs)
    if bad:
        fail('qdot_int8 disagrees with its plain version: ' + '; '.join(bad))
    return {'qdot_int8': (worst,)}


def int8pack_call(torch, x, w):
    """``torch._weight_int8pack_mm``, PyTorch's one call for a W8A16
    product, on x and the weight transposed to its [N, K] layout (built
    here, outside any timed call): (call, None), or (None, the reason)
    when this torch has no CUDA kernel for it."""
    try:
        wt = w.q.t().contiguous()
        torch._weight_int8pack_mm(x, wt, w.scale)
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError) as exc:
        reason = f'{type(exc).__name__}: {str(exc).splitlines()[0][:160]}'
        print(f'torch._weight_int8pack_mm: {reason}', flush=True)
        return None, reason
    return (lambda xm: torch._weight_int8pack_mm(xm, wt, w.scale)), None


def time_qdot_kernel(torch, quant):
    """Phase 4, the int8-weight product at each 8B weight shape at
    QDOT_TIMED_ROWS rows: the kernel, its plain version and two library
    yardsticks: ``torch.matmul`` of the same x with the bf16 dequantized
    weight (what a bf16 server runs, reading twice the weight bytes; the
    kernel line's ``library_ms``) and ``torch._weight_int8pack_mm`` on
    the int8 weight (``int8pack_ms``, None with ``int8pack_note`` where
    the card's torch has no kernel for it). Prints the table; returns the
    kernel line's row (QDOT_MAIN at 64 rows, a decode step's product)."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    table, main = [], None
    for name, (k, n) in QDOT_SHAPES.items():
        if name not in QDOT_8B + QDOT_TP2:
            continue
        x, w = qdot_case(torch, quant, gen, k, n)
        wb = w.q.to(torch.bfloat16) * w.scale[None, :]
        int8pack, note = int8pack_call(torch, x, w)
        for m in QDOT_TIMED_ROWS:
            xm = x[:m]
            r = dict(
                ms=time_ms(torch, lambda: quant.qdot(xm, w), 20, flush),
                plain_ms=time_ms(torch, lambda: quant.qdot_reference(xm, w),
                                 5, flush),
                library_ms=time_ms(torch, lambda: torch.matmul(xm, wb), 20,
                                   flush),
                int8pack_ms=None if int8pack is None else time_ms(
                    torch, lambda: int8pack(xm), 20, flush),
                int8pack_note=note,
                bound=bound(m * k * 2 + k * n + n * 2 + m * n * 2,
                            2.0 * m * k * n))
            table.append({'weight': name, 'K': k, 'N': n, 'M': m,
                          'splits': quant.cuda_splits(k, n), **r})
            if name == QDOT_MAIN and m == QDOT_TIMED_ROWS[0]:
                main = r
        del x, w, wb, int8pack
    print('qdot_int8 timing (' + card_line() + '): ' + json.dumps(table),
          flush=True)
    for r in table:
        pack = '—' if r['int8pack_ms'] is None \
            else f'{r["int8pack_ms"]:.4f}'
        print(f'  qdot_int8 {r["weight"]} M {r["M"]}: {r["ms"]:.4f} ms, '
              f'plain {r["plain_ms"]:.4f}, bf16 matmul {r["library_ms"]:.4f}, '
              f'_weight_int8pack_mm {pack}, '
              f'bound {r["bound"][0]:.4f} ({r["bound"][1]})', flush=True)
    return {'qdot_int8': main}


# ---------------------------------------------------------------------------
# Phase 5: end to end through the server
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def http_json(url: str, body=None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def burst(base: str, prompts, new: int, vocab: int, stream_last=False,
          spec=True):
    """Send every prompt at once (the last one streamed if
    ``stream_last``; ``spec`` is the body's speculation opt-in), check
    each answer, and return ([(tokens, ttft_s, latency_s,
    accepted_len_mean)] in prompt order, wall seconds)."""
    results = [None] * len(prompts)
    errors = []

    def one(i):
        stream = stream_last and i == len(prompts) - 1
        body = {'tokens': prompts[i], 'max_new_tokens': new,
                'temperature': 0.0, 'stream': stream, 'spec': spec}
        t0 = time.perf_counter()
        try:
            status, raw = http_json(base + '/generate', body)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(f'request {i}: {e!r}')
            return
        latency = time.perf_counter() - t0
        if stream:
            lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
            if status != 200 or not lines or not lines[-1].get('done'):
                errors.append(f'stream: status {status}, last line '
                              f'{lines[-1] if lines else None}')
                return
            tokens = [t for ln in lines[:-1] for t in ln['tokens']]
            answer = lines[-1]
        else:
            answer = json.loads(raw)
            if status != 200:
                errors.append(f'request {i}: status {status}: {answer}')
                return
            tokens = answer['tokens']
        results[i] = (tokens, answer['ttft_s'], latency,
                      answer['accepted_len_mean'])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(r is None for r in results):
        fail(f'requests failed: {errors}')
    for i, (tokens, *_) in enumerate(results):
        if len(tokens) != new:
            fail(f'request {i}: {len(tokens)} tokens, expected {new}')
        if not all(0 <= t < vocab for t in tokens):
            fail(f'request {i}: token ids outside the vocabulary')
    return results, wall


def spec_check(base: str, vocab: int):
    """Repetitive prompts sent with speculation off and on must give the
    same tokens. Each prompt is a 4-token pattern x 16 led by its own
    greedy continuation (learnt from a first, speculation-off pass):
    once the model emits that continuation's opening again, the
    prompt-lookup drafter finds it in the prompt and drafts the rest.
    Returns a summary."""
    import random
    rnd = random.Random(1)
    new = 32
    patterns = [[rnd.randrange(vocab) for _ in range(4)] * 16
                for _ in range(8)]
    first, _ = burst(base, patterns, new, vocab, spec=False)
    prompts = [r[0][:16] + p for r, p in zip(first, patterns)]
    off, off_wall = burst(base, prompts, new, vocab, spec=False)
    on, on_wall = burst(base, prompts, new, vocab, spec=True)
    if [r[0] for r in on] != [r[0] for r in off]:
        fail('speculation changed the tokens of a greedy request')
    if any(r[3] is not None for r in off):
        fail('a request sent with "spec": false rode a verify step')
    _, raw = http_json(base + '/metrics')
    m = json.loads(raw)
    return {'requests': len(prompts), 'max_new_tokens': new,
            'accepted_len_mean_per_request': [r[3] for r in on],
            'spec_off_wall_s': off_wall, 'spec_on_wall_s': on_wall,
            **{k: m.get(k) for k in ('spec_steps', 'spec_drafted_tokens',
                                     'spec_accepted_tokens',
                                     'spec_accept_rate',
                                     'accepted_len_mean')}}


def serve_and_check(base: str, vocab: int, card: str, kernels, label: str):
    """Mixed-length requests (one streamed) twice, a greedy repeat, a
    burst of short prompts that decodes on all slots, and the
    speculation check, against a warm server. ``kernels``: the wrappers
    that must have launched. Returns (kernel launch deltas, summary)."""
    import random
    rnd = random.Random(0)
    lengths = [17, 300, 1000, 64, 129]   # the 129-token one is streamed
    prompts = [[rnd.randrange(vocab) for _ in range(n)] for n in lengths]
    new = 32
    _, raw = http_json(base + '/metrics')
    before = json.loads(raw)['kernel_launches']

    # The first burst is the first live run of each prefill bucket's
    # program (captured at warm-up); the second runs them warm.
    cold, cold_wall = burst(base, prompts, new, vocab, stream_last=True)
    warm, warm_wall = burst(base, prompts, new, vocab, stream_last=True)
    # Greedy determinism: the first request alone gives the same tokens.
    [(again, *_)], _ = burst(base, prompts[:1], new, vocab)
    if again != cold[0][0]:
        fail('a repeated greedy request gave different tokens')
    # Decode on every slot: 8 short prompts, 64 new tokens each. The
    # time between tokens is (latency - ttft) / (new - 1) per request.
    dnew = 64
    dprompts = [[rnd.randrange(vocab) for _ in range(64)] for _ in range(8)]
    dec, dec_wall = burst(base, dprompts, dnew, vocab)
    itl_ms = [(lat - ttft) / (dnew - 1) * 1e3 for _, ttft, lat, _ in dec]
    spec = spec_check(base, vocab)

    _, raw = http_json(base + '/metrics')
    metrics = json.loads(raw)
    after = metrics['kernel_launches']
    launches = {k: after[k] - before[k] for k in after}
    summary = {
        'card': card,
        'requests': 2 * len(prompts) + 1 + len(dprompts),
        'mixed_prompt_tokens': lengths, 'mixed_max_new_tokens': new,
        'ttft_cold_s': [r[1] for r in cold],
        'ttft_cold_p50_s': statistics.median(r[1] for r in cold),
        'mixed_cold_wall_s': cold_wall,
        'ttft_warm_s': [r[1] for r in warm],
        'ttft_warm_p50_s': statistics.median(r[1] for r in warm),
        'mixed_warm_wall_s': warm_wall,
        'decode_burst': {'requests': len(dprompts), 'prompt_tokens': 64,
                         'max_new_tokens': dnew, 'wall_s': dec_wall,
                         'tokens_per_sec': len(dprompts) * dnew / dec_wall,
                         'itl_ms': itl_ms,
                         'itl_p50_ms': statistics.median(itl_ms)},
        'speculation': spec,
        'decode_steps': metrics['decode_steps'],
        'decode_tokens': metrics['decode_tokens'],
        'kv_dtype': metrics.get('kv_dtype'),
        'kv_page_bytes': metrics.get('kv_page_bytes'),
        'kernel_launches': launches,
        **{k: metrics.get(k) for k in ('scheduler', 'pipeline_depth',
                                       'cuda_graphs', 'step_programs',
                                       'preemptions', 'paged',
                                       'kv_cache_bytes')},
    }
    print(f'end to end (Llama-3-8B, random weights, {label}, '
          + card + '): ' + json.dumps(summary), flush=True)
    if metrics['pipeline_depth'] != 1 or not metrics['cuda_graphs']:
        fail(f'the server did not run its default loop (depth 1, CUDA '
             f'graphs): {label}')
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f'{name} was not launched on the main path ({label})')
    return launches, summary


@contextlib.contextmanager
def served(args, log_name: str):
    """``python -m skypilot_tpu_torch.infer.server`` started with ``args``
    in a subprocess (its output to ``OUT_DIR / log_name``), waited on
    until healthy (fails if it exits, its loop dies or 600 s pass);
    yields its base URL and stops it, process group and all."""
    OUT_DIR.mkdir(exist_ok=True)
    port = free_port()
    log_path = OUT_DIR / log_name
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
           '--host', '127.0.0.1', '--port', str(port), *args]
    print('starting: ' + ' '.join(cmd[1:]), flush=True)
    t0 = time.time()
    with open(log_path, 'wb') as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=log,
                                start_new_session=True)
        try:
            base = f'http://127.0.0.1:{port}'
            while True:
                if proc.poll() is not None:
                    tail = log_path.read_text(errors='replace')[-4000:]
                    fail(f'server exited {proc.returncode}:\n{tail}')
                if time.time() - t0 > 600:
                    fail('server not healthy within 600 s')
                try:
                    status, raw = http_json(base + '/health', timeout=5)
                    if status == 200 and json.loads(raw)['status'] == 'ok':
                        break
                except urllib.error.HTTPError as e:
                    if json.loads(e.read()).get('status') == 'dead':
                        tail = log_path.read_text(errors='replace')[-4000:]
                        fail(f'the server\'s engine loop died:\n{tail}')
                except (urllib.error.URLError, ConnectionError, OSError):
                    pass
                time.sleep(1.0)
            print(f'server healthy after {time.time() - t0:.1f} s',
                  flush=True)
            yield base
        finally:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)


def run_server(card: str, flags, log_name: str, kernels, label: str):
    with served(['--model', '8b', '--paged', '--slots', '8',
                 '--max-seq-len', str(MAX_SEQ), *flags], log_name) as base:
        return serve_and_check(base, 128_256, card, kernels, label)


# ---------------------------------------------------------------------------
# Phase 5b: speculation in process at full 8B width and depth
# ---------------------------------------------------------------------------
class OracleDrafter:
    """Proposes each known prompt's speculation-off greedy continuation;
    for the prompts in ``wrong`` the draft's token at index ``wrong_at``
    is off by one, so those runs are accepted up to it and rejected
    there."""

    def __init__(self, prompts, outputs, wrong, wrong_at, vocab):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]
        self.wrong = {tuple(p) for p in wrong}
        self.wrong_at, self.vocab = wrong_at, vocab

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                draft = out[len(context) - len(prompt):][:k]
                if tuple(prompt) in self.wrong and len(draft) > self.wrong_at:
                    draft[self.wrong_at] = (draft[self.wrong_at] + 1) % \
                        self.vocab
                return draft
        return []


def prefill_logits(torch, model_lib, pc_lib, cfg, params, rope, tokens,
                   dtype):
    """Logits after ``tokens`` through the prefill path on a fresh
    one-slot cache of ``dtype`` pages, in PREFILL_C-token chunks. Returns
    (logits [vocab], cache, table row)."""
    maxp, C = MAX_SEQ // PAGE, PREFILL_C
    cache = pc_lib.init_paged_cache(cfg.n_layers, 1, maxp + 1, PAGE,
                                    cfg.n_kv_heads, cfg.head_dim, dtype=dtype,
                                    device='cuda')
    row = torch.arange(1, maxp + 1, dtype=torch.int32, device='cuda')
    for off in range(0, len(tokens), C):
        chunk = tokens[off:off + C]
        padded = torch.zeros(C, dtype=torch.int32, device='cuda')
        padded[:len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
        cache, logits = model_lib.paged_prefill_chunk(
            cfg, params, cache, 0, row, padded, off, len(chunk), rope)
    return logits, cache, row


# The engine's default chunk buckets at page 64 and chunk cap 256.
CHUNK_BUCKETS = (64, 128, 256)


def one_graph_each(counts, verify: bool, mixed: bool = False) -> bool:
    """The greedy steady state of the step programs: one decode graph,
    one verify graph with speculation, one prefill graph (and, fused,
    one mixed graph) per chunk bucket used, none of another kind."""
    kinds = {'prefill', 'decode'} | ({'verify'} if verify else set()) \
        | ({'mixed'} if mixed else set())
    return (set(counts) == kinds and counts['decode'] == 1
            and counts.get('verify', 1) == 1
            and 1 <= counts['prefill'] <= len(CHUNK_BUCKETS)
            and (not mixed or 1 <= counts['mixed'] <= len(CHUNK_BUCKETS)))


def serving_in_process(torch, pa, card: str):
    """Phases 5b and 5c, in process at full 8B width and depth (random
    weights, seed 0), 8 prompts x SPEC_NEW new tokens on 8 slots.

    5b, for bf16 and for int8 pages: greedy tokens of the synchronous
    eager loop (depth 0, CUDA graphs off) and of the default loop (depth
    1, graphs on) must be identical, speculation off, and again with
    speculation on (spec_k 4, an oracle drafter that proposes the
    speculation-off continuation, wrong at a fixed draft index for half
    the prompts); speculation on must give speculation-off's tokens
    (every verify query is bitwise decode, phase 3), accept drafts and
    leak no page. 5c: the default loop with speculation on over a pool
    cut to POOL_CUT pages, which must preempt, gives the uncut pool's
    tokens (a preempted request may part after its resume only at a
    near-tie, NEAR_TIE), every page comes back and ``compiled_counts()``
    stays at one decode and one verify graph (and one prefill graph per
    chunk bucket). Then the int8-vs-bf16 decode-logit delta, which must
    be > 0."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import paged_cache as pc_lib
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, 'cuda')
    rnd = random.Random(4)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in SPEC_PROMPT_LENGTHS]

    def run(kv_dtype, depth, graphs, oracle=None, n_pages=None):
        """One engine over ``prompts``: its tokens and what it did."""
        eng = engine_lib.InferenceEngine(
            cfg, params, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
                kv_dtype=kv_dtype, pipeline_depth=depth,
                cuda_graphs=graphs, n_pages=n_pages,
                spec_k=VERIFY_R - 1 if oracle else 0),
            seed=0, device='cuda')
        if oracle:
            eng._drafter = OracleDrafter(prompts, oracle, prompts[1::2],
                                         ORACLE_WRONG_AT, cfg.vocab_size)
        # Which request each preemption evicted, and after how many of
        # its tokens (ids count from 1 in submission order).
        preempted = []
        evict = eng._preempt

        def logged(slot):
            req = eng._slots[slot]
            preempted.append((req.request_id - 1, len(req.output_tokens)))
            evict(slot)
        eng._preempt = logged
        pa.reset_launches()
        t1 = time.perf_counter()
        tokens = [r.output_tokens for r in eng.generate(prompts, SPEC_NEW)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        m = eng.metrics()
        al = eng.allocator
        out = {'tokens': tokens, 'wall_s': wall, 'preempted': preempted,
               'launches': {k: v for k, v in pa.launches.items() if v},
               'compiled_counts': eng.compiled_counts(),
               'pages_leaked': al.n_pages - 1 - al.free_pages,
               'refcounts': sum(al.refcount(p) for p in range(1, al.n_pages)),
               **{k: m.get(k) for k in (
                   'decode_steps', 'preemptions', 'pipeline_depth',
                   'cuda_graphs', 'spec_steps', 'spec_drafted_tokens',
                   'spec_accepted_tokens', 'accepted_len_mean')}}
        rope = eng._rope
        del eng
        torch.cuda.empty_cache()
        return out, rope

    def parted(a, b):
        return [(i, next((j for j, (x, y) in enumerate(zip(p, q))
                          if x != y), min(len(p), len(q))))
                for i, (p, q) in enumerate(zip(a, b)) if p != q]

    def brief(r):
        return {k: v for k, v in r.items() if k != 'tokens'}

    summary = {'card': card, 'prompt_tokens': SPEC_PROMPT_LENGTHS,
               'max_new_tokens': SPEC_NEW, 'spec_k': VERIFY_R - 1,
               'oracle_wrong_at': ORACLE_WRONG_AT}
    lanes = {}
    for kv in ('bfloat16', 'int8'):
        suffix = '_int8' if kv == 'int8' else ''
        eager, rope = run(kv, 0, False)
        fast, _ = run(kv, 1, True)
        spec_eager, _ = run(kv, 0, False, oracle=eager['tokens'])
        spec_fast, _ = run(kv, 1, True, oracle=eager['tokens'])
        lanes[kv] = (eager, fast, spec_eager, spec_fast)
        summary[kv] = {
            'depth0_graphs_off': brief(eager), 'depth1_graphs_on': brief(fast),
            'spec_depth0_graphs_off': brief(spec_eager),
            'spec_depth1_graphs_on': brief(spec_fast),
            'parted_graphs_depth': parted(eager['tokens'], fast['tokens']),
            'parted_graphs_depth_spec': parted(spec_eager['tokens'],
                                               spec_fast['tokens']),
            'parted_spec_on_off': parted(eager['tokens'],
                                         spec_eager['tokens'])}
        for r in (eager, fast, spec_eager, spec_fast):
            for name in ('paged_decode_attention', 'paged_prefill_attention'):
                if r['launches'].get(name + suffix, 0) <= 0:
                    fail(f'{name + suffix} was not launched in phase 5b')
        for r in (spec_eager, spec_fast):
            if r['launches'].get('paged_verify_attention' + suffix, 0) <= 0:
                fail(f'paged_verify_attention{suffix} was not launched in '
                     f'phase 5b')
    # 5c: the default loop, speculation on, over a cut pool.
    cut, _ = run('bfloat16', 1, True, oracle=lanes['bfloat16'][0]['tokens'],
                 n_pages=POOL_CUT)
    uncut = lanes['bfloat16'][3]['tokens']
    summary['pool_cut'] = {'n_pages': POOL_CUT, **brief(cut),
                           'parted_from_uncut': parted(uncut,
                                                       cut['tokens'])}
    # Where the cut run parts from the uncut one: the uncut
    # continuation's top-2 margin there, recomputed by prefill.
    ties = []
    for i, j in summary['pool_cut']['parted_from_uncut']:
        logits, cache, _ = prefill_logits(torch, model_lib, pc_lib, cfg,
                                          params, rope,
                                          prompts[i] + uncut[i][:j],
                                          torch.bfloat16)
        del cache
        top2 = torch.topk(logits.float(), 2).values.tolist()
        resumed = [n for r, n in cut['preempted'] if r == i]
        ties.append({'request': i, 'step': j, 'resumed_at': resumed,
                     'margin': top2[0] - top2[1], 'top_logit': top2[0]})
    summary['pool_cut']['near_ties'] = ties
    # int8 vs bf16 at these shapes: prefill the first prompt into each
    # kind of cache, decode one step, compare the logits.
    step = {}
    for dtype in (torch.bfloat16, torch.int8):
        logits, cache, row = prefill_logits(torch, model_lib, pc_lib, cfg,
                                            params, rope, prompts[0], dtype)
        tok = torch.argmax(logits).to(torch.int32).reshape(1)
        step[dtype], _ = model_lib.paged_decode_step(cfg, params, cache,
                                                     row[None], tok, rope)
        del cache
    delta = (step[torch.bfloat16] - step[torch.int8]).abs().max().item()
    summary['int8_vs_bf16_decode_logit_delta'] = delta
    summary['wall_s'] = time.perf_counter() - t0
    print('serving loop in process (Llama-3-8B, random weights, 8 slots, '
          + card + '): ' + json.dumps(summary), flush=True)
    for kv, (eager, fast, spec_eager, spec_fast) in lanes.items():
        s = summary[kv]
        if s['parted_graphs_depth'] or s['parted_graphs_depth_spec']:
            fail(f'{kv}: depth 1 with CUDA graphs parted from depth 0 '
                 f'eager: {s["parted_graphs_depth"]} (spec off), '
                 f'{s["parted_graphs_depth_spec"]} (spec on)')
        if s['parted_spec_on_off']:
            fail(f'{kv}: speculation on parted from speculation off: '
                 f'{s["parted_spec_on_off"]}')
        for r in (spec_eager, spec_fast):
            if r['spec_accepted_tokens'] < 1:
                fail(f'{kv}: the oracle run accepted no draft: the check '
                     f'is vacuous')
        for r in (eager, fast, spec_eager, spec_fast):
            if r['pages_leaked'] or r['refcounts']:
                fail(f'{kv}: pages leaked: {brief(r)}')
        if not (one_graph_each(fast['compiled_counts'], False)
                and one_graph_each(spec_fast['compiled_counts'], True)):
            fail(f'{kv}: step graphs {fast["compiled_counts"]} (spec off), '
                 f'{spec_fast["compiled_counts"]} (spec on); want one '
                 f'decode and one verify graph, and at most one prefill '
                 f'graph per chunk bucket')
        if not (fast['cuda_graphs'] and not eager['cuda_graphs']):
            fail(f'{kv}: the graph switch did not take')
    c = summary['pool_cut']
    if c['preemptions'] < 1:
        fail(f'the cut pool of {POOL_CUT} pages never preempted')
    if c['pages_leaked'] or c['refcounts']:
        fail(f'the preempting run leaked pages: {c}')
    for t in ties:
        if not (t['resumed_at'] and t['step'] >= min(t['resumed_at'])
                and t['margin'] <= NEAR_TIE * abs(t['top_logit'])):
            fail(f'the preempting run parted from the uncut pool away from '
                 f'a near-tie after a resume: {t}')
    if not one_graph_each(c['compiled_counts'], True):
        fail(f'the preempting run captured {c["compiled_counts"]} graphs')
    if not delta > 0:
        fail('int8 and bf16 pages gave the same decode logits: the int8 '
             'path did not run')
    del params
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 5d: fused mixed steps, the SDC sentinel and the chunked sweep
# ---------------------------------------------------------------------------
def fused_in_process(torch, pa, card: str):
    """Phase 5d, in process at full 8B width and depth (random weights,
    seed 0), 8 slots, bf16 and int8 pages: 5b's prompts (SPEC_NEW new
    tokens each, FUSED_SHORT for the 17-token one, whose slot frees
    mid-decode) and a FUSED_AGGRESSOR-token aggressor submitted once every
    request has decoded a few tokens, so its chunks arrive mid-decode.

    Fused on vs off must give identical token lists at depth 0 eager
    (graphs off) and at depth 1 with graphs, speculation off and on (the
    oracle drafter of 5b); fused runs must dispatch mixed steps and never
    stall the decode batch on a standalone chunk, and hold one mixed graph
    per chunk bucket used; the sentinel off must give the same tokens,
    decode_steps and programs. Then a NaN planted in the embedding row of
    a token that only one prompt holds: that request finishes 'sdc', the
    engine turns integrity_suspect and the server's /health answers 503
    corrupt; the requests run after it on the same engine give the clean
    run's tokens (their prefill chunks take the dead request's freed
    pages first and overwrite them whole)."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, 'cuda')
    rnd = random.Random(4)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in SPEC_PROMPT_LENGTHS]
    aggressor = [rnd.randrange(cfg.vocab_size)
                 for _ in range(FUSED_AGGRESSOR)]
    budgets = [FUSED_SHORT if n == 17 else SPEC_NEW
               for n in SPEC_PROMPT_LENGTHS]

    def workload(eng):
        """The prompts, then the aggressor once all have decoded 4
        tokens; returns every request's tokens (aggressor last)."""
        reqs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        while any(len(r.output_tokens) < 4 and not r.done for r in reqs):
            eng.step()
        reqs.append(eng.submit(aggressor, SPEC_NEW))
        eng.run_until_idle()
        return [r.output_tokens for r in reqs], [r.finish_reason
                                                 for r in reqs]

    def run(kv_dtype, depth, graphs, fused, oracle=None, sentinel=True):
        """One engine over the workload: its tokens and what it did."""
        eng = engine_lib.InferenceEngine(
            cfg, params, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
                kv_dtype=kv_dtype, pipeline_depth=depth,
                cuda_graphs=graphs, fused_prefill=fused,
                sdc_sentinel=sentinel,
                spec_k=VERIFY_R - 1 if oracle else 0),
            seed=0, device='cuda')
        if oracle:
            eng._drafter = OracleDrafter(prompts + [aggressor], oracle,
                                         prompts[1::2], ORACLE_WRONG_AT,
                                         cfg.vocab_size)
        pa.reset_launches()
        t1 = time.perf_counter()
        tokens, reasons = workload(eng)
        torch.cuda.synchronize()
        m = eng.metrics()
        al = eng.allocator
        out = {'tokens': tokens, 'reasons': reasons,
               'wall_s': time.perf_counter() - t1,
               'launches': {k: v for k, v in pa.launches.items() if v},
               'compiled_counts': eng.compiled_counts(),
               'pages_leaked': al.n_pages - 1 - al.free_pages,
               **{k: m.get(k) for k in (
                   'decode_steps', 'fused_steps', 'decode_stall_steps',
                   'prefill_tokens_per_step', 'preemptions', 'spec_steps',
                   'spec_accepted_tokens', 'integrity',
                   'sdc_events_total')}}
        del eng
        return out

    def brief(r):
        return {k: v for k, v in r.items() if k != 'tokens'}

    summary = {'card': card, 'prompt_tokens': SPEC_PROMPT_LENGTHS,
               'aggressor_tokens': FUSED_AGGRESSOR, 'new_tokens': budgets}
    checks = []
    for kv in ('bfloat16', 'int8'):
        suffix = '_int8' if kv == 'int8' else ''
        lane = {}
        for depth, graphs in ((0, False), (1, True)):
            for fused in (False, True):
                lane[(depth, fused, False)] = run(kv, depth, graphs, fused)
        reference = lane[(0, False, False)]['tokens']
        if kv == 'bfloat16':
            lanes_bf16 = lane
        for depth, graphs in ((0, False), (1, True)):
            for fused in (False, True):
                lane[(depth, fused, True)] = run(kv, depth, graphs, fused,
                                                 oracle=reference)
        torch.cuda.empty_cache()
        summary[kv] = {f'depth{d}_{"fused" if f else "unfused"}'
                       f'{"_spec" if sp else ""}': brief(r)
                       for (d, f, sp), r in lane.items()}
        for key, r in lane.items():
            depth, fused, spec = key
            parted = [i for i, (a, b) in enumerate(zip(r['tokens'],
                                                       reference)) if a != b]
            if parted:
                checks.append(f'{kv} {key}: requests {parted} parted from '
                              f'depth 0 unfused')
            if r['pages_leaked']:
                checks.append(f'{kv} {key}: {r["pages_leaked"]} pages leaked')
            for name in ('paged_decode_attention', 'paged_prefill_attention'):
                if r['launches'].get(name + suffix, 0) <= 0:
                    checks.append(f'{kv} {key}: {name + suffix} never '
                                  f'launched')
            if fused and (r['fused_steps'] <= 0
                          or r['decode_stall_steps'] != 0):
                checks.append(f'{kv} {key}: fused run dispatched '
                              f'{r["fused_steps"]} mixed steps and stalled '
                              f'{r["decode_stall_steps"]}')
            if not fused and r['decode_stall_steps'] <= 0:
                checks.append(f'{kv} {key}: the unfused run never stalled: '
                              f'the aggressor did not arrive mid-decode')
            if spec and r['spec_accepted_tokens'] < 1:
                checks.append(f'{kv} {key}: the oracle run accepted no draft')
            if depth == 1 and not one_graph_each(r['compiled_counts'], spec,
                                                 fused):
                checks.append(f'{kv} {key}: step graphs '
                              f'{r["compiled_counts"]}')
            if 'mixed' in r['compiled_counts'] and not fused:
                checks.append(f'{kv} {key}: a mixed program with fused off')
    # The sentinel off: the same tokens, steps and programs.
    on = lanes_bf16[(1, True, False)]
    off = run('bfloat16', 1, True, True, sentinel=False)
    summary['sentinel_off'] = brief(off)
    for key in ('tokens', 'decode_steps', 'compiled_counts', 'fused_steps'):
        if off[key] != on[key]:
            checks.append(f'the sentinel off changed {key}')
    # The NaN row: a token only prompt 0 holds.
    others = set(aggressor).union(*map(set, prompts[1:]))
    bad = next(t for t in prompts[0] if t not in others)
    poisoned = dict(params, embed=params['embed'].clone())
    poisoned['embed'][bad] = float('nan')
    nan_eng = engine_lib.InferenceEngine(
        cfg, poisoned, engine_lib.EngineConfig(
            n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
            pipeline_depth=1, fused_prefill=True),
        seed=0, device='cuda')
    victim = nan_eng.submit(prompts[0], SPEC_NEW)
    nan_eng.run_until_idle()
    health = server_lib.InferenceServer(nan_eng).health()
    m = nan_eng.metrics()
    summary['nan_row'] = {'token': bad, 'finish_reason': victim.finish_reason,
                          'health': health, 'integrity': m['integrity'],
                          'sdc_events_total': m['sdc_events_total']}
    if victim.finish_reason != 'sdc' or health != (503, {'status':
                                                         'corrupt'}):
        checks.append(f'the NaN row did not trip the sentinel: '
                      f'{summary["nan_row"]}')
    # The same engine serves the workload on: prompt 0 finishes 'sdc'
    # again, every other request must give the clean run's tokens.
    tokens, reasons = workload(nan_eng)
    parted = [i for i in range(1, len(tokens))
              if tokens[i] != on['tokens'][i]]
    summary['nan_row'].update(after_reasons=reasons, parted_after=parted,
                              sdc_events_after=nan_eng.metrics()[
                                  'sdc_events_total'])
    if reasons[0] != 'sdc' or 'sdc' in reasons[1:] or parted:
        checks.append(f'after the NaN row: reasons {reasons}, requests '
                      f'{parted} parted from the clean run')
    del nan_eng, poisoned, params
    torch.cuda.empty_cache()
    summary['wall_s'] = time.perf_counter() - t0
    print('fused mixed steps in process (Llama-3-8B, random weights, 8 '
          'slots, ' + card + '): ' + json.dumps(summary), flush=True)
    for c in checks:
        print('phase 5d: ' + c, flush=True)
    if checks:
        fail(f'phase 5d: {len(checks)} checks failed (above)')
    return summary


# ---------------------------------------------------------------------------
# Phase 5e: the shared-prefix KV cache and KV prefix transfer
# ---------------------------------------------------------------------------
class TreeGuard:
    """Keeps, on the card, a copy of each page the prefix tree takes
    (donated or imported) and holds every page still in the tree to it:
    a step that wrote a cached page (an inactive lane's garbage row, a
    missed copy-on-write) fails it even where no token shows it."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.snap = torch, eng, {}
        for name in ('donate', 'insert_remote'):
            orig = getattr(eng.prefix, name)

            def wrapped(*a, _orig=orig, **kw):
                out = _orig(*a, **kw)
                self._take()
                return out
            setattr(eng.prefix, name, wrapped)

    def nodes(self):
        stack = list(self.eng.prefix._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def page(self, pid):
        c = self.eng.cache
        return [t[:, :, pid].clone() for t in
                (c.k_pages, c.v_pages, c.k_scales, c.v_scales)
                if t is not None]

    def _take(self):
        for node in self.nodes():
            if id(node) not in self.snap:
                self.snap[id(node)] = (node, self.page(node.page_id))

    def changed(self):
        """(pages held, ids of held pages whose bytes changed)."""
        held = list(self.nodes())
        bad = [n.page_id for n in held
               if not all(self.torch.equal(a, b) for a, b in zip(
                   self.page(n.page_id), self.snap[id(n)][1]))]
        return len(held), bad


def prefix_in_process(torch, pa, card: str):
    """Phase 5e, in process at full 8B width and depth (random weights,
    seed 0), 8 slots, pages of 64, bf16 and int8 pages.

    The workload: a PREFIX_SYSTEM-token system block with a 16-token tail
    served alone (it seeds the tree), then PREFIX_LONG-token unique
    prompt and seven more tails together, then the fourth tail again (the
    repeat), each PREFIX_NEW new tokens; the cache-on engine's pool is
    cut to PREFIX_POOL pages. The cache-off engine at depth 0 eager (full
    pool) is the reference; the cache-on
    engine at depth 0 eager and at depth 1 with CUDA graphs, speculation
    off and on (5b's oracle drafter), and fused at depth 1, must give its
    token lists exactly (a preempted request may part after its resume
    only at a near-tie, NEAR_TIE, as in 5c); a cache-on run must preempt,
    every tail after
    the seed must hit, ``compiled_counts()`` must be the cache-off
    engine's plus ``cow: 0``, no page may leak, and every page the tree
    holds must keep the bytes it had when donated. The prefill (its
    device-scalar entry), decode and verify kernels must launch in the
    cache-on runs.

    Then a transfer between two in-process 8B engines: an int8 export's
    blob is page_wire_bytes a page plus its header, the import lands the
    donor's bytes exactly and the puller's tokens are a local
    recompute's; a bf16 export lands within half a scale step of the
    donor's rows; the numpy quantizer of the wire is bitwise the card's
    int8 write path on layer 0's rows (the same in both pools)."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import kv_wire
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import paged_cache as pc_lib
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, 'cuda')
    rope = model_lib.rope_tables(cfg, 'cuda')
    rnd = random.Random(5)
    system = [rnd.randrange(cfg.vocab_size) for _ in range(PREFIX_SYSTEM)]
    tails = [[rnd.randrange(cfg.vocab_size) for _ in range(PREFIX_TAIL)]
             for _ in range(PREFIX_TAILS)]
    long_prompt = [rnd.randrange(cfg.vocab_size) for _ in range(PREFIX_LONG)]
    seed_prompt = system + tails[0]
    batch = [long_prompt] + [system + t for t in tails[1:]]
    repeat = system + tails[3]
    prompts = [seed_prompt] + batch + [repeat]

    def engine(kv_dtype, depth, graphs, prefix, spec=False, fused=False,
               n_pages=PREFIX_POOL):
        return engine_lib.InferenceEngine(
            cfg, params, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
                kv_dtype=kv_dtype, pipeline_depth=depth, cuda_graphs=graphs,
                n_pages=n_pages, prefix_cache=prefix, fused_prefill=fused,
                spec_k=VERIFY_R - 1 if spec else 0),
            seed=0, device='cuda')

    def workload(eng):
        first = eng.submit(seed_prompt, PREFIX_NEW)
        eng.run_until_idle()
        reqs = [eng.submit(p, PREFIX_NEW) for p in batch]
        eng.run_until_idle()
        again = eng.submit(repeat, PREFIX_NEW)
        eng.run_until_idle()
        return [first] + reqs + [again]

    def run(kv_dtype, depth, graphs, prefix, oracle=None, fused=False):
        eng = engine(kv_dtype, depth, graphs, prefix, spec=bool(oracle),
                     fused=fused, n_pages=PREFIX_POOL if prefix else None)
        if oracle:
            eng._drafter = OracleDrafter(prompts, oracle, prompts[1::2],
                                         ORACLE_WRONG_AT, cfg.vocab_size)
        guard = TreeGuard(torch, eng) if prefix else None
        preempted = []
        evict = eng._preempt

        def logged(slot):
            req = eng._slots[slot]
            preempted.append((req.request_id - 1, len(req.output_tokens)))
            evict(slot)
        eng._preempt = logged
        pa.reset_launches()
        t1 = time.perf_counter()
        reqs = workload(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        m = eng.metrics()
        al = eng.allocator
        cached = eng.prefix.cached_pages if prefix else 0
        out = {'tokens': [r.output_tokens for r in reqs],
               'reasons': [r.finish_reason for r in reqs],
               'cached_tokens': [r.cached_tokens for r in reqs],
               'seed_ttft_s': reqs[0].ttft, 'repeat_ttft_s': reqs[-1].ttft,
               'wall_s': wall, 'preempted': preempted,
               'launches': {k: v for k, v in pa.launches.items() if v},
               'compiled_counts': eng.compiled_counts(),
               'pages_leaked': al.n_pages - 1 - al.free_pages - cached,
               'shared_refs': sum(al.refcount(p) > 1
                                  for p in range(1, al.n_pages)),
               **{k: m.get(k) for k in (
                   'decode_steps', 'preemptions', 'fused_steps',
                   'spec_accepted_tokens', 'prefix_hits', 'prefix_misses',
                   'prefix_tokens_saved', 'prefix_cached_pages',
                   'prefix_evictions')}}
        if guard is not None:
            out['tree_pages'], out['tree_pages_changed'] = guard.changed()
        del eng, guard
        torch.cuda.empty_cache()
        return out

    def brief(r):
        return {k: v for k, v in r.items() if k != 'tokens'}

    summary = {'card': card, 'system_tokens': PREFIX_SYSTEM,
               'tail_tokens': PREFIX_TAIL, 'tails': PREFIX_TAILS,
               'long_prompt_tokens': PREFIX_LONG, 'new_tokens': PREFIX_NEW,
               'n_pages': PREFIX_POOL}
    checks = []
    launches = dict.fromkeys(pa.launches, 0)
    refs = {}
    for kv in ('bfloat16', 'int8'):
        suffix = '_int8' if kv == 'int8' else ''
        ref = refs[kv] = run(kv, 0, False, False)
        off_fast = run(kv, 1, True, False)
        lane = {'off_depth1_graphs': off_fast}
        for depth, graphs in ((0, False), (1, True)):
            for spec in (False, True):
                lane[f'on_depth{depth}{"_graphs" if graphs else ""}'
                     f'{"_spec" if spec else ""}'] = run(
                    kv, depth, graphs, True,
                    oracle=ref['tokens'] if spec else None)
        lane['on_depth1_graphs_fused'] = run(kv, 1, True, True, fused=True)
        summary[kv] = {'off_depth0_eager': brief(ref),
                       **{k: brief(r) for k, r in lane.items()}}
        for key, r in lane.items():
            r['near_ties'] = []
            for i, (a, b) in enumerate(zip(r['tokens'], ref['tokens'])):
                if a == b:
                    continue
                # A preempted request resumes by recomputing its decoded
                # tokens' K/V through prefill (ROADMAP queue 3, as 5c):
                # after its resume it may part only at a near-tie.
                j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                resumed = [n for q, n in r['preempted'] if q == i]
                tie = {'request': i, 'step': j, 'resumed_at': resumed}
                if resumed and j >= min(resumed):
                    logits, cache, _ = prefill_logits(
                        torch, model_lib, pc_lib, cfg, params, rope,
                        prompts[i] + b[:j],
                        torch.int8 if kv == 'int8' else torch.bfloat16)
                    del cache
                    top2 = torch.topk(logits.float(), 2).values.tolist()
                    tie.update(margin=top2[0] - top2[1], top_logit=top2[0])
                r['near_ties'].append(tie)
                if not (tie.get('margin') is not None and tie['margin']
                        <= NEAR_TIE * abs(tie['top_logit'])):
                    checks.append(f'{kv} {key}: request {i} parted from the '
                                  f'cache-off engine away from a near-tie '
                                  f'after a resume: {tie}')
            if r['pages_leaked'] or r['shared_refs']:
                checks.append(f'{kv} {key}: pages leaked or still shared: '
                              f'{r["pages_leaked"]} / {r["shared_refs"]}')
            if key.startswith('off'):
                continue
            for name, n in r['launches'].items():
                launches[name] += n
            if r['tree_pages_changed'] or not r['tree_pages']:
                checks.append(f'{kv} {key}: tree pages changed '
                              f'{r["tree_pages_changed"]} of '
                              f'{r["tree_pages"]}')
            hit = r['cached_tokens'][2:]
            if hit != [PREFIX_SYSTEM] * len(hit) or r['cached_tokens'][1]:
                checks.append(f'{kv} {key}: cached tokens '
                              f'{r["cached_tokens"]}: every tail after the '
                              f'seed must attach the system block')
            need = ['paged_decode_attention', 'paged_prefill_attention']
            if key.endswith('_spec'):
                need.append('paged_verify_attention')
                if r['spec_accepted_tokens'] < 1:
                    checks.append(f'{kv} {key}: the oracle run accepted no '
                                  f'draft')
            for name in need:
                if r['launches'].get(name + suffix, 0) <= 0:
                    checks.append(f'{kv} {key}: {name + suffix} never '
                                  f'launched')
            if key.endswith('fused') and r['fused_steps'] < 1:
                checks.append(f'{kv} {key}: no mixed step')
        on_fast = lane['on_depth1_graphs']
        if on_fast['compiled_counts'] != {**off_fast['compiled_counts'],
                                          'cow': 0}:
            checks.append(f'{kv}: the cache changed the step programs: '
                          f'{on_fast["compiled_counts"]} vs '
                          f'{off_fast["compiled_counts"]}')
        spec_counts = dict(lane['on_depth1_graphs_spec']['compiled_counts'])
        if spec_counts.pop('cow', None) != 0 or not one_graph_each(
                spec_counts, True):
            checks.append(f'{kv}: speculation with the cache captured '
                          f'{lane["on_depth1_graphs_spec"]["compiled_counts"]}')
        if not any(r['preemptions'] for k, r in lane.items()
                   if k.startswith('on')):
            checks.append(f'{kv}: no cache-on run preempted over '
                          f'{PREFIX_POOL} pages')

    # KV prefix transfer between two in-process engines.
    page_bytes = kv_wire.page_wire_bytes(cfg.n_layers, cfg.n_kv_heads, PAGE,
                                         cfg.head_dim)
    transfer = {}
    donors = {}
    for kv in ('int8', 'bfloat16'):
        donor = engine(kv, 1, True, True, n_pages=None)
        donor.generate([seed_prompt], PREFIX_NEW)
        pids, matched = donor.prefix.peek(seed_prompt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        blob = donor._kv_export(seed_prompt)
        export_ms = (time.perf_counter() - t1) * 1e3
        blk = kv_wire.unpack(blob)
        puller = engine(kv, 1, True, True, n_pages=None)
        guard = TreeGuard(torch, puller)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grafted = puller._kv_import(blob)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t1) * 1e3
        got, n = puller.prefix.peek(seed_prompt)
        row = {'pages': len(pids), 'matched_tokens': matched,
               'blob_bytes': len(blob),
               'payload_bytes': len(pids) * page_bytes,
               'header_bytes': len(blob) - len(pids) * page_bytes,
               'page_wire_bytes': page_bytes, 'grafted': grafted,
               'export_ms': export_ms, 'import_ms': import_ms}
        if kv == 'int8':
            exact = all(torch.equal(getattr(puller.cache, name)[:, :, got],
                                    getattr(donor.cache, name)[:, :, pids])
                        for name in ('k_pages', 'v_pages', 'k_scales',
                                     'v_scales'))
            # The tails' tokens of the cache-off engine above: a local
            # recompute of the same prompts.
            reqs = puller.generate(batch[1:], PREFIX_NEW)
            want = refs['int8']['tokens'][2:2 + len(batch) - 1]
            row.update(byte_exact=exact,
                       cached_tokens=[r.cached_tokens for r in reqs],
                       parted=[i for i, r in enumerate(reqs)
                               if r.output_tokens != want[i]])
            if not exact or row['parted'] or any(
                    c != PREFIX_SYSTEM for c in row['cached_tokens']):
                checks.append(f'int8 transfer: {row}')
        else:
            land = puller.cache.k_pages[:, :, got].float().cpu().numpy()
            mine = donor.cache.k_pages[:, :, pids].float().cpu().numpy()
            deq = kv_wire.dequantize_rows_np(blk.k, blk.k_scales)
            err = float(abs(deq - mine).max())
            ok = bool((abs(deq - mine) <= blk.k_scales[..., None] * 0.5
                       + 1e-6).all())
            cast = torch.from_numpy(deq).to(torch.bfloat16).float().numpy()
            row.update(max_abs_err=err, within_half_step=ok,
                       lands_dequantized=bool((land == cast).all()))
            if not (ok and row['lands_dequantized']):
                checks.append(f'bf16 transfer: {row}')
        held, changed = guard.changed()
        row['puller_tree_pages'], row['puller_tree_changed'] = held, changed
        if changed or grafted != len(pids) or n != matched:
            checks.append(f'{kv} transfer: grafted {grafted} of {len(pids)},'
                          f' tree pages changed {changed}')
        if row['payload_bytes'] >= len(blob) or row['header_bytes'] > 65536:
            checks.append(f'{kv} transfer: blob {len(blob)} bytes for '
                          f'{len(pids)} pages of {page_bytes}')
        transfer[kv] = row
        donors[kv] = (donor, pids)
        del puller, guard
    # The wire's numpy quantizer against the card's int8 write path: layer
    # 0's rows come from the embeddings alone, so the bf16 pool holds the
    # rows the int8 pool quantized.
    (bdonor, bpids), (idonor, ipids) = donors['bfloat16'], donors['int8']
    rows_k = bdonor.cache.k_pages[0][:, bpids].float().cpu().numpy()
    q, sc = kv_wire.quantize_rows_np(rows_k)
    q_diff = int((q != idonor.cache.k_pages[0][:, ipids].cpu().numpy()).sum())
    s_diff = int((sc != idonor.cache.k_scales[0][:, ipids].cpu().numpy())
                 .sum())
    quant_ok = q_diff == 0 and s_diff == 0
    transfer['quantize_rows_np_bitwise_card_int8_write'] = quant_ok
    transfer['quantize_rows_np_differing'] = {'values': q_diff,
                                              'scales': s_diff,
                                              'of_rows': int(sc.size)}
    if not quant_ok:
        checks.append('quantize_rows_np differs from the card\'s int8 write '
                      'path on layer 0')
    del donors, bdonor, idonor, params
    torch.cuda.empty_cache()
    summary['transfer'] = transfer
    summary['launches'] = launches
    summary['wall_s'] = time.perf_counter() - t0
    print('prefix cache in process (Llama-3-8B, random weights, 8 slots, '
          + card + '): ' + json.dumps(summary), flush=True)
    for c in checks:
        print('phase 5e: ' + c, flush=True)
    if checks:
        fail(f'phase 5e: {len(checks)} checks failed (above)')
    return launches


def chunked_sweep(torch, card: str) -> dict:
    """``skypilot_tpu_torch.bench_ttft --sweep chunked`` at one level (7
    victims and the aggressor on 8 slots, chunk buckets 64 and 128 as in
    the reference), in process: its JSON document on a line of its own.
    Fails unless the fused engine fused and never stalled, the unfused
    one stalled, and the victims' time between tokens was measured."""
    from skypilot_tpu_torch import bench_ttft
    doc = bench_ttft.sweep(['--sweep', 'chunked', '--model', '8b',
                            '--device', 'cuda', '--slots', '8',
                            '--max-seq-len', str(MAX_SEQ)])
    print(json.dumps(doc), flush=True)
    level = doc['sweep'][0]
    fused, unfused = level['fused'], level['unfused']
    if not (fused['fused_steps'] > 0 and fused['decode_stall_steps'] == 0
            and unfused['decode_stall_steps'] > 0
            and fused['victim_itl_p99_ms'] and unfused['victim_itl_p99_ms']
            and doc['card']):
        fail(f'the chunked sweep did not measure what it should: '
             f'{json.dumps(level)[:2000]}')
    torch.cuda.empty_cache()
    return doc


# ---------------------------------------------------------------------------
# Phase 5f: int8 weights end to end
# ---------------------------------------------------------------------------
def int8_weights_in_process(torch, pa, quant, card: str):
    """Phase 5f, in process at full 8B width and depth (random weights,
    seed 0), bf16 pages.

    1. The card's quantizer against the CPU's, on layer 0's weights and
       the embedding of the 8B init: int8 bytes and bf16 scales bitwise.
    2. ``EngineConfig(quantize=True)`` over 5b's 8 prompts x SPEC_NEW new
       tokens: depth 0 eager against depth 1 with CUDA graphs, speculation
       on (5b's oracle drafter) against off, and with 5d's aggressor
       arriving mid-decode, fused on against off (depth 0 eager and depth
       1 graphs): every token list identical, one graph per program kind,
       no page leaked, qdot_int8 and the paged kernels launched; the
       quantized tree at most 0.55 of the bf16 tree's bytes.
    Returns a summary for the server comparison."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, 'cuda')
    checks = []
    # 1. The quantizer, card against CPU.
    t1 = time.perf_counter()
    for key in ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down'):
        leaf = params['layers'][key][0]
        card_q, cpu_q = (quant.quantize_weight(leaf),
                         quant.quantize_weight(leaf.cpu()))
        if not (torch.equal(card_q.q.cpu(), cpu_q.q)
                and torch.equal(card_q.scale.cpu(), cpu_q.scale)):
            checks.append(f'the card quantized layer 0 {key} other than '
                          f'the CPU')
    card_e, cpu_e = (quant.quantize_embed(params['embed']),
                     quant.quantize_embed(params['embed'].cpu()))
    if not (torch.equal(card_e.q.cpu(), cpu_e.q)
            and torch.equal(card_e.scale.cpu(), cpu_e.scale)):
        checks.append('the card quantized the embedding other than the CPU')
    del card_e, cpu_e
    quantizer_s = time.perf_counter() - t1
    bf16_bytes = quant.param_bytes(params)
    qparams = quant.quantize_params(params)
    del params
    torch.cuda.empty_cache()
    int8_bytes = quant.param_bytes(qparams)
    if int8_bytes > 0.55 * bf16_bytes:
        checks.append(f'int8 params {int8_bytes} bytes, over 0.55 of the '
                      f'bf16 {bf16_bytes}')
    rnd = random.Random(4)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in SPEC_PROMPT_LENGTHS]
    aggressor = [rnd.randrange(cfg.vocab_size)
                 for _ in range(FUSED_AGGRESSOR)]
    budgets = [FUSED_SHORT if n == 17 else SPEC_NEW
               for n in SPEC_PROMPT_LENGTHS]

    def run(depth, graphs, oracle=None, fused=None):
        """One int8-weight engine over the prompts (with ``fused`` not
        None: 5d's workload, the aggressor mid-decode)."""
        eng = engine_lib.InferenceEngine(
            cfg, qparams, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
                pipeline_depth=depth, cuda_graphs=graphs,
                fused_prefill=bool(fused), quantize=True,
                spec_k=VERIFY_R - 1 if oracle else 0),
            seed=0, device='cuda')
        if oracle:
            eng._drafter = OracleDrafter(prompts, oracle, prompts[1::2],
                                         ORACLE_WRONG_AT, cfg.vocab_size)
        pa.reset_launches()
        quant.reset_launches()
        t1 = time.perf_counter()
        if fused is None:
            tokens = [r.output_tokens
                      for r in eng.generate(prompts, SPEC_NEW)]
        else:
            reqs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
            while any(len(r.output_tokens) < 4 and not r.done
                      for r in reqs):
                eng.step()
            reqs.append(eng.submit(aggressor, SPEC_NEW))
            eng.run_until_idle()
            tokens = [r.output_tokens for r in reqs]
        torch.cuda.synchronize()
        m = eng.metrics()
        al = eng.allocator
        out = {'tokens': tokens, 'wall_s': time.perf_counter() - t1,
               'launches': {k: v for k, v in {**pa.launches,
                                               **quant.launches}.items()
                            if v},
               'compiled_counts': eng.compiled_counts(),
               'pages_leaked': al.n_pages - 1 - al.free_pages,
               **{k: m.get(k) for k in (
                   'decode_steps', 'fused_steps', 'decode_stall_steps',
                   'spec_steps', 'spec_accepted_tokens', 'param_bytes')}}
        del eng
        return out

    eager = run(0, False)
    lanes = {'depth0_graphs_off': eager,
             'depth1_graphs_on': run(1, True),
             'spec_depth0_graphs_off': run(0, False, oracle=eager['tokens']),
             'spec_depth1_graphs_on': run(1, True, oracle=eager['tokens'])}
    fused_ref = run(0, False, fused=False)
    fused_lanes = {'fused_off_depth0': fused_ref,
                   'fused_on_depth0': run(0, False, fused=True),
                   'fused_off_depth1': run(1, True, fused=False),
                   'fused_on_depth1': run(1, True, fused=True)}
    torch.cuda.empty_cache()
    for name, r in [*lanes.items(), *fused_lanes.items()]:
        want = (fused_ref if name.startswith('fused') else eager)['tokens']
        parted = [i for i, (a, b) in enumerate(zip(r['tokens'], want))
                  if a != b]
        if parted:
            checks.append(f'{name}: requests {parted} parted')
        if r['pages_leaked']:
            checks.append(f'{name}: {r["pages_leaked"]} pages leaked')
        for kernel in ('qdot_int8', 'paged_decode_attention',
                       'paged_prefill_attention'):
            if r['launches'].get(kernel, 0) <= 0:
                checks.append(f'{name}: {kernel} never launched')
        spec = name.startswith('spec')
        fused = name.startswith('fused_on')
        if spec and (r['spec_accepted_tokens'] or 0) < 1:
            checks.append(f'{name}: the oracle run accepted no draft')
        if spec and r['launches'].get('paged_verify_attention', 0) <= 0:
            checks.append(f'{name}: paged_verify_attention never launched')
        if fused and (r['fused_steps'] <= 0 or r['decode_stall_steps']):
            checks.append(f'{name}: {r["fused_steps"]} mixed steps, '
                          f'{r["decode_stall_steps"]} stalls')
        if 'depth1' in name and not one_graph_each(
                r['compiled_counts'], spec, fused):
            checks.append(f'{name}: step graphs {r["compiled_counts"]}')
    summary = {
        'card': card, 'prompt_tokens': SPEC_PROMPT_LENGTHS,
        'max_new_tokens': SPEC_NEW, 'aggressor_tokens': FUSED_AGGRESSOR,
        'quantizer_check_s': quantizer_s, 'param_bytes_bf16': bf16_bytes,
        'param_bytes_int8': int8_bytes,
        'param_bytes_ratio': int8_bytes / bf16_bytes,
        **{name: {k: v for k, v in r.items() if k != 'tokens'}
           for name, r in [*lanes.items(), *fused_lanes.items()]},
        'wall_s': time.perf_counter() - t0}
    print('phase 5f (int8 weights in process, Llama-3-8B, bf16 pages, '
          + card + '): ' + json.dumps(summary), flush=True)
    if checks:
        for c in checks:
            print('phase 5f: ' + c, flush=True)
        fail(f'phase 5f: {len(checks)} checks failed (above)')
    del qparams
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# --profile: where a decode step's time goes
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Phase 5g: the dense cache and the two-tier pool
# ---------------------------------------------------------------------------
DENSE_KERNELS = ('paged_decode_attention', 'paged_prefill_attention',
                 'paged_verify_attention')


def dense_in_process(torch, pa, card: str):
    """5g(a), in process at full 8B width and depth (random weights, seed
    0), 5b's 8 prompts x SPEC_NEW new tokens on 8 slots of the dense
    cache (bf16, the reference's buckets 16/64/256): depth 0 eager is the
    reference; depth 1 with CUDA graphs, speculation on (the oracle
    drafter, depth 1, graphs) and fused on (depth 1, graphs) must give
    its tokens exactly; step programs one decode and one verify graph, at
    most three chunk and three mixed graphs; the dense runs' decode,
    prefill and verify launches (counted from 0 before the first, read
    after the last) all non-zero. Then the paged engine on the same
    weights (depth 1, graphs): its tokens may part from the dense ones
    only at a near-tie (NEAR_TIE) of the dense continuation's top-2
    logits, each parting printed. Returns (summary, launches)."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import paged_cache as pc_lib
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, 'cuda')
    rnd = random.Random(4)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in SPEC_PROMPT_LENGTHS]

    def run(depth, graphs, oracle=None, fused=False, paged=False):
        eng = engine_lib.InferenceEngine(
            cfg, params, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, paged=paged, page_size=PAGE,
                pipeline_depth=depth, cuda_graphs=graphs,
                fused_prefill=fused, spec_k=VERIFY_R - 1 if oracle else 0),
            seed=0, device='cuda')
        if oracle:
            eng._drafter = OracleDrafter(prompts, oracle, prompts[1::2],
                                         ORACLE_WRONG_AT, cfg.vocab_size)
        t1 = time.perf_counter()
        tokens = [r.output_tokens for r in eng.generate(prompts, SPEC_NEW)]
        torch.cuda.synchronize()
        m = eng.metrics()
        out = {'tokens': tokens, 'wall_s': time.perf_counter() - t1,
               **{k: m.get(k) for k in (
                   'paged', 'step_programs', 'decode_steps', 'fused_steps',
                   'spec_accepted_tokens', 'cuda_graphs',
                   'kv_cache_bytes')}}
        del eng
        torch.cuda.empty_cache()
        return out

    pa.reset_launches()
    base = run(0, False)
    fast = run(1, True)
    spec = run(1, True, oracle=base['tokens'])
    fused = run(1, True, fused=True)
    launches = {k: v for k, v in pa.launches.items() if v}
    paged = run(1, True, paged=True)

    def parted(a, b):
        return [(i, next((j for j, (x, y) in enumerate(zip(p, q))
                          if x != y), min(len(p), len(q))))
                for i, (p, q) in enumerate(zip(a, b)) if p != q]

    ties = []
    rope = model_lib.rope_tables(cfg, 'cuda')
    for i, j in parted(base['tokens'], paged['tokens']):
        logits, cache, _ = prefill_logits(torch, model_lib, pc_lib, cfg,
                                          params, rope,
                                          prompts[i] + base['tokens'][i][:j],
                                          torch.bfloat16)
        del cache
        top2 = torch.topk(logits.float(), 2).values.tolist()
        ties.append({'request': i, 'step': j, 'margin': top2[0] - top2[1],
                     'top_logit': top2[0]})
    brief = {name: {k: v for k, v in r.items() if k != 'tokens'}
             for name, r in (('depth0_eager', base), ('depth1_graphs', fast),
                             ('spec_depth1_graphs', spec),
                             ('fused_depth1_graphs', fused),
                             ('paged_depth1_graphs', paged))}
    summary = {'card': card, 'prompt_tokens': SPEC_PROMPT_LENGTHS,
               'max_new_tokens': SPEC_NEW, **brief,
               'parted_depth': parted(base['tokens'], fast['tokens']),
               'parted_spec': parted(base['tokens'], spec['tokens']),
               'parted_fused': parted(base['tokens'], fused['tokens']),
               'dense_vs_paged_near_ties': ties,
               'dense_launches': launches,
               'wall_s': time.perf_counter() - t0}
    print('dense cache in process (Llama-3-8B, random weights, 8 slots, '
          'bf16, ' + card + '): ' + json.dumps(summary), flush=True)
    for key in ('parted_depth', 'parted_spec', 'parted_fused'):
        if summary[key]:
            fail(f'dense: {key}: {summary[key]} (must be bitwise)')
    if spec['spec_accepted_tokens'] < 1 or fused['fused_steps'] < 1:
        fail('dense: the oracle run accepted no draft or the fused run '
             'fused no step: the check is vacuous')
    for t in ties:
        if t['margin'] > NEAR_TIE * abs(t['top_logit']):
            fail(f'dense parted from paged away from a near-tie: {t}')
    for name, r in (('depth 1', fast), ('spec', spec), ('fused', fused)):
        c = r['step_programs']
        if not (r['cuda_graphs'] and r['paged'] is False
                and c['decode'] == 1 and c.get('verify', 1) == 1
                and 1 <= c['prefill'] <= 3 and c.get('mixed', 0) <= 3):
            fail(f'dense {name}: step programs {c}, graphs '
                 f'{r["cuda_graphs"]}, paged {r["paged"]}')
    if any(launches.get(k, 0) <= 0 for k in DENSE_KERNELS):
        fail(f'a paged kernel was not launched on the dense path (a '
             f'fallback?): {launches}')
    del params
    torch.cuda.empty_cache()
    return summary, launches


def dense_replica(torch, quant, card: str):
    """5g(b)-(d): the replica at DENSE_REPLICA with ``--spec-k 4`` and no
    ``--paged`` (a dense tier of 16 x 2048 and a long one of 2 x 8192 over
    one int8 copy of the weights). (c): ``coldstart.compiled`` must come
    after both tiers' warm-up requests finished, and at ready each tier
    must hold every greedy step program (a chunk graph per DENSE_BUCKETS
    entry, decode, verify). (b): phase 5's burst
    (``serve_and_check``, ``/metrics`` must say ``paged: false``), then a
    DENSE_LONG_PROMPT-token prompt, twice, which must route to the long
    tier (its request id's residue and the tier's decode tokens) and give
    the tokens of an in-process engine of the long tier's shape on the
    same int8 weights. (d): prints the burst's time between tokens and
    tokens/s, the long prompt's warm TTFT and each tier's KV bytes beside
    the card. Returns the replica's kernel launches."""
    import random
    from skypilot_tpu_torch.infer import server as server_lib
    rnd = random.Random(7)
    vocab = server_lib.MODELS['8b']().vocab_size
    long_prompt = [rnd.randrange(vocab) for _ in range(DENSE_LONG_PROMPT)]
    new = 32
    with served([*DENSE_REPLICA, '--spec-k', str(VERIFY_R - 1)],
                'chip_smoke_server_dense_pool.log') as base:
        _, raw = http_json(base + '/debug/stepline')
        events = json.loads(raw)['events']
        done = {e['request_id']: e['t'] for e in events
                if e['event'] == 'done'}
        compiled = [e['t'] for e in events
                    if e['event'] == 'coldstart.compiled']
        # Warm-up ids: tier 0 counts 1, 3, ..., tier 1 counts 2, 4, ...
        if not (compiled and 1 in done and 2 in done
                and max(done[1], done[2]) <= compiled[0]):
            fail(f'coldstart.compiled came before both tiers were warm: '
                 f'done {done}, compiled {compiled}')
        # Every tier captured each greedy program before it turned ready:
        # a chunk graph per bucket, decode and verify.
        _, raw = http_json(base + '/metrics')
        warmed = [t['step_programs'] for t in json.loads(raw)['tiers']]
        if any(c != {'prefill': len(DENSE_BUCKETS), 'decode': 1,
                     'verify': 1} for c in warmed):
            fail(f'a tier turned ready before every step program was '
                 f'captured: {warmed}')
        launches, summary = serve_and_check(
            base, vocab, card, ('qdot_int8',) + DENSE_KERNELS,
            'dense two-tier pool, int8 weights, spec_k 4')
        _, raw = http_json(base + '/metrics')
        before = json.loads(raw)
        answers = []
        for _ in range(2):
            status, raw = http_json(base + '/generate', {
                'tokens': long_prompt, 'max_new_tokens': new})
            answers.append(json.loads(raw))
        _, raw = http_json(base + '/metrics')
        m = json.loads(raw)
    tiers = m['tiers']
    long_tokens = tiers[1]['decode_tokens'] - before['tiers'][1][
        'decode_tokens']
    qparams = server_lib.random_params(
        server_lib.MODELS['8b'](), 0, torch.device('cuda'), quantize=True)
    eng = server_lib.build_engine('8b', 2, LONG_SEQ, PAGE, None, 'cuda',
                                  seed=1, spec_k=VERIFY_R - 1,
                                  params=qparams)
    [want] = eng.generate([long_prompt], new)
    del eng, qparams
    torch.cuda.empty_cache()
    out = {'card': card, 'flags': DENSE_REPLICA + ['--spec-k', '4'],
           'paged': m['paged'],
           'itl_p50_ms': summary['decode_burst']['itl_p50_ms'],
           'tokens_per_sec': summary['decode_burst']['tokens_per_sec'],
           'ttft_warm_p50_s': summary['ttft_warm_p50_s'],
           'long_prompt_tokens': DENSE_LONG_PROMPT,
           'long_ttft_s': [a['ttft_s'] for a in answers],
           'long_ttft_warm_s': answers[1]['ttft_s'],
           'long_request_ids': [a['request_id'] for a in answers],
           'long_tier_decode_tokens': long_tokens,
           'kv_cache_bytes': {f'{t["n_slots"]}x{t["max_seq_len"]}':
                              t['kv_cache_bytes'] for t in tiers},
           'param_bytes': m['param_bytes'],
           'step_programs_at_ready': warmed,
           'step_programs': [t['step_programs'] for t in tiers]}
    print('dense two-tier replica (Llama-3-8B, int8 weights, random, '
          + card + '): ' + json.dumps(out), flush=True)
    if m['paged'] is not False or any(t['paged'] for t in tiers):
        fail(f'the replica without --paged is not dense: {m["paged"]}')
    if any((a['request_id'] - 1) % 2 != 1 for a in answers) \
            or long_tokens != sum(len(a['tokens']) for a in answers):
        fail(f'the long prompt did not route to the long tier: ids '
             f'{out["long_request_ids"]}, long-tier tokens {long_tokens}')
    for a in answers:
        if a['tokens'] != want.output_tokens:
            fail(f'the long tier\'s tokens differ from the in-process '
                 f'engine\'s: {a["tokens"][:8]} vs {want.output_tokens[:8]}')
    return launches


# ---------------------------------------------------------------------------
# Phase 5h: tensor parallelism, two ranks over gloo on the one card
# ---------------------------------------------------------------------------
TP_KERNELS = ('paged_decode_attention', 'paged_prefill_attention',
              'paged_verify_attention')


def tp_rank(rank: int, world: int, address: str, out_path: str, prompts,
            oracles) -> None:
    """One rank of phase 5h (a spawned process): joins the gloo group on
    cuda:0, then per variant (bf16, then int8 weights) draws its slices
    of seed 0's 8B weights, builds a dense tp engine (8 slots, spec_k 4,
    the oracle drafter over ``oracles[variant]``, CUDA graphs off: gloo's
    collectives stage through the host) and serves ``prompts`` through
    the lockstep driver, its kernel counters set to 0 just before. Writes
    its tokens (rank 0), launches, ticks and step times to
    ``out_path``."""
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import multihost
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops import quant
    from skypilot_tpu_torch.parallel import mesh
    group = mesh.tp_group(rank, world, address, 'cuda:0', backend='gloo')
    cfg = llama.LlamaConfig.llama3_8b()
    result = {}
    for variant in ('bf16', 'int8_weights'):
        gen = torch.Generator(device='cuda:0')
        gen.manual_seed(0)
        if variant == 'bf16':
            params = engine_lib.init_params_sharded(cfg, world, rank, 0,
                                                    'cuda:0')
        else:
            params = quant.init_params_quantized(cfg, gen, 'cuda:0', world,
                                                 rank)
        eng = engine_lib.InferenceEngine(
            cfg, params, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, spec_k=VERIFY_R - 1,
                cuda_graphs=False),
            seed=0, device='cuda:0', group=group)
        eng._drafter = OracleDrafter(prompts, oracles[variant],
                                     prompts[1::2], ORACLE_WRONG_AT,
                                     cfg.vocab_size)
        drv = multihost.MultihostEngineDriver(eng, group)
        out = {}

        def work():
            reqs = [drv.submit(p, max_new_tokens=TP_NEW) for p in prompts]
            for r in reqs:
                r.wait_done()
            out['tokens'] = [r.output_tokens for r in reqs]
            drv.stop()

        torch.cuda.synchronize()
        pa.reset_launches()
        quant.reset_launches()
        t0 = time.perf_counter()
        if rank == 0:
            t = threading.Thread(target=work)
            t.start()
            drv.run()
            t.join()
        else:
            drv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = eng.metrics()
        result[variant] = {
            'tokens': out.get('tokens'), 'ticks': drv.ticks,
            'wall_s': wall, 'ms_per_tick': wall * 1e3 / max(1, drv.ticks),
            'ms_per_step': (eng._decode_time * 1e3
                            / max(1, m['decode_steps'])),
            'launches': {k: v for k, v in {**pa.launches,
                                           **quant.launches}.items() if v},
            **{k: m[k] for k in ('decode_steps', 'spec_steps',
                                 'spec_accepted_tokens', 'cuda_graphs',
                                 'pipeline_depth', 'kv_cache_bytes',
                                 'param_bytes')}}
        del drv, eng, params
        torch.cuda.empty_cache()
    pathlib.Path(out_path).write_text(json.dumps(result))
    mesh.destroy(group)


def tp_in_process(torch, quant, card: str):
    """Phase 5h: the tp=1 dense engine (8 slots, depth 1, graphs) serves
    5b's first TP_PROMPTS prompts x TP_NEW tokens on seed 0's 8B weights,
    bf16 and int8; then two spawned ranks share the card over gloo at tp
    2 (``tp_rank``) and serve them through the lockstep driver with spec_k
    4 and the oracle drafter (its drafts the tp=1 tokens). Every tp 2
    token list must equal the tp=1 one, except after a near-tie
    (NEAR_TIE) of the tp=1 continuation's top-2 logits; both ranks must
    have launched decode, prefill and verify (and qdot_int8 with int8
    weights); the lockstep loop compared the ranks' output digests every
    tick (a mismatch exits the rank with 42). Prints each rank's time a
    tick and a step, labelled gloo on one card. Returns the launches, summed
    over ranks and variants."""
    import random
    import torch.multiprocessing as mp
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import paged_cache as pc_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    rnd = random.Random(4)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in SPEC_PROMPT_LENGTHS][:TP_PROMPTS]
    params, tp1 = {}, {}
    for variant in ('bf16', 'int8_weights'):
        gen = torch.Generator(device='cuda')
        gen.manual_seed(0)
        params[variant] = (llama.init_params(cfg, gen, 'cuda')
                           if variant == 'bf16' else
                           quant.init_params_quantized(cfg, gen, 'cuda'))
        eng = engine_lib.InferenceEngine(
            cfg, params[variant], engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ), seed=0, device='cuda')
        tp1[variant] = [r.output_tokens
                        for r in eng.generate(prompts, TP_NEW)]
        del eng
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f'rank{r}.json') for r in range(2)]
        address = f'127.0.0.1:{mesh.free_port()}'
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=tp_rank, args=(r, 2, address, outs[r],
                                                   prompts, tp1))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 600
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            fail(f'phase 5h: rank exit codes {codes} (42: the lockstep '
                 f'watchdog or a digest mismatch)')
        ranks = [json.loads(pathlib.Path(o).read_text()) for o in outs]

    def parted(a, b):
        return [(i, next((j for j, (x, y) in enumerate(zip(p, q))
                          if x != y), min(len(p), len(q))))
                for i, (p, q) in enumerate(zip(a, b)) if p != q]

    rope = model_lib.rope_tables(cfg, 'cuda')
    checks, ties, launches = [], {}, {}
    for variant in ('bf16', 'int8_weights'):
        got = ranks[0][variant]['tokens']
        ties[variant] = []
        for i, j in parted(tp1[variant], got):
            logits, cache, _ = prefill_logits(
                torch, model_lib, pc_lib, cfg, params[variant], rope,
                prompts[i] + tp1[variant][i][:j], torch.bfloat16)
            del cache
            top2 = torch.topk(logits.float(), 2).values.tolist()
            t = {'request': i, 'step': j, 'margin': top2[0] - top2[1],
                 'top_logit': top2[0]}
            ties[variant].append(t)
            if t['margin'] > NEAR_TIE * abs(t['top_logit']):
                checks.append(f'{variant}: tp 2 parted from tp 1 away from '
                              f'a near-tie: {t}')
        want = TP_KERNELS + (('qdot_int8',) if variant == 'int8_weights'
                             else ())
        for r, res in enumerate(ranks):
            run = res[variant]
            missing = [k for k in want if run['launches'].get(k, 0) <= 0]
            if missing:
                checks.append(f'{variant} rank {r}: {missing} not launched '
                              f'({run["launches"]})')
            if run['cuda_graphs'] or run['pipeline_depth'] != 0:
                checks.append(f'{variant} rank {r}: graphs '
                              f'{run["cuda_graphs"]}, depth '
                              f'{run["pipeline_depth"]}')
            for k, n in run['launches'].items():
                launches[k] = launches.get(k, 0) + n
        if ranks[0][variant]['ticks'] != ranks[1][variant]['ticks']:
            checks.append(f'{variant}: the ranks ran {ranks[0][variant]["ticks"]}'
                          f' and {ranks[1][variant]["ticks"]} ticks')
        if ranks[0][variant]['spec_accepted_tokens'] < 1:
            checks.append(f'{variant}: no draft accepted: verify is vacuous')
    summary = {'card': card, 'backend': 'gloo, two ranks on one card',
               'prompt_tokens': SPEC_PROMPT_LENGTHS[:TP_PROMPTS],
               'max_new_tokens': TP_NEW, 'near_ties': ties,
               'ranks': [{v: {k: x for k, x in res[v].items()
                              if k != 'tokens'} for v in res}
                         for res in ranks],
               'wall_s': time.perf_counter() - t0}
    print('tp 2 in process (Llama-3-8B, dense, 8 slots, spec_k 4, gloo on '
          'one card: a correctness run, not a speed one; ' + card + '): '
          + json.dumps(summary), flush=True)
    for variant in ('bf16', 'int8_weights'):
        for r, res in enumerate(ranks):
            run = res[variant]
            print(f'  tp 2 {variant} rank {r} (gloo on one card): '
                  f'{run["ms_per_tick"]:.2f} ms a tick, '
                  f'{run["ms_per_step"]:.2f} ms a step, {run["ticks"]} ticks '
                  f'with the digests compared', flush=True)
    if checks:
        for c in checks:
            print('phase 5h: ' + c, flush=True)
        fail(f'phase 5h: {len(checks)} checks failed (above)')
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5i: the rest of the replica, booted twice on one kernel directory
# ---------------------------------------------------------------------------
# The serving recipe's single-chip flags (5g's replica without its long
# tier) with speculation and weighted fair queueing, as bench_ttft takes
# them, and an admission bound, which the bench forwards only to its
# tenants sweep's server and 5i passes to its boots itself.
SWEEP_BENCH = ['--model', '8b', '--quantize', '--slots', '16',
               '--max-seq-len', str(MAX_SEQ), '--spec-k', '6',
               '--scheduler', 'wfq']
SWEEP_QUEUE = ['--max-queue-requests', '64']
SWEEP_REPLICA = SWEEP_BENCH + SWEEP_QUEUE
# The wrappers the replica (dense cache, int8 weights) must launch during
# the sweeps.
SWEEP_KERNELS = DENSE_KERNELS + ('qdot_int8',)
# A fixed greedy prompt both boots must answer alike.
SWEEP_PROMPT_SEED, SWEEP_PROMPT_LEN, SWEEP_NEW = 11, 300, 32
# A spliced stream's resume recomputes its delivered tokens' K/V through
# prefill (ROADMAP.md queue 3 item B), so it may part from its
# uninterrupted twin, but only at a near-tie: the twin's token and the
# spliced stream's where they part must both lie within RESUME_TIE_STEPS
# bf16 steps of the twin's top logit there. How many of the chaos level's
# 8 streams part is no bound: it depends on where each stream is cut, and
# the cut on how many tokens the server's first lines carried. On an H100
# (NVIDIA H100 80GB HBM3, 700.00 W) resume_ties.py gives, at cut 7, the
# same 3 partings in every repeat, and at other cuts other counts
# (PERF.md section 6).
RESUME_TIE_STEPS = 4


def bf16_step(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def parting_tie(torch, model_lib, pc_lib, cfg, params, rope, prompt,
                twin, spliced, j):
    """Where a spliced stream parts from its uninterrupted twin, at token
    ``j``: the twin's logits there (its prompt and first ``j`` tokens
    through the prefill path), the two streams' tokens, the top logit,
    and the gap from the top logit to the lower of the two tokens', in
    bf16 steps of the top logit (infinite where a stream ended first)."""
    logits, cache, _ = prefill_logits(torch, model_lib, pc_lib, cfg, params,
                                      rope, prompt + twin[:j], torch.bfloat16)
    del cache
    logits = logits.float()
    top = logits.max().item()
    if j >= min(len(twin), len(spliced)):
        return {'step': j, 'top_logit': top, 'margin': math.inf,
                'bf16_steps': math.inf}
    margin = top - min(logits[twin[j]].item(), logits[spliced[j]].item())
    return {'step': j, 'twin_token': twin[j], 'spliced_token': spliced[j],
            'top_logit': top, 'margin': margin,
            'bf16_steps': margin / bf16_step(top)}


def resume_check(torch, chaos):
    """5i's chaos level against the engine itself: an in-process engine
    built from SWEEP_REPLICA as the server builds it (the same seed-0 int8
    weights) resumes each spliced stream from the tokens delivered before
    its cut. Returns the streams whose splice differs from that resume
    (must be none), and for each stream that parted from its
    uninterrupted twin its cut and ``parting_tie`` where it parted."""
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import paged_cache as pc_lib
    from skypilot_tpu_torch.infer import server as server_lib
    sargs = server_lib.parse_args(['--port', '0', *SWEEP_REPLICA])
    eng = server_lib.engine_from_args(sargs)
    reqs = [eng.submit(list(p['prompt'].encode()), max_new_tokens=SWEEP_NEW,
                       resume_tokens=p['tokens'][:p['cut_at']])
            for p in chaos['spliced']]
    while not all(r.done for r in reqs):
        eng.step()
    wrong = [{'request': p['request'], 'cut_at': p['cut_at'],
              'spliced': p['tokens'], 'engine': r.output_tokens}
             for p, r in zip(chaos['spliced'], reqs)
             if r.output_tokens != p['tokens']]
    cfg = eng.config
    rope = model_lib.rope_tables(cfg, 'cuda')
    spliced = {p['request']: p for p in chaos['spliced']}
    ties = []
    for p in chaos['parted']:
        s = spliced[p['request']]
        ties.append({'request': p['request'], 'cut_at': s['cut_at'],
                     **parting_tie(torch, model_lib, pc_lib, cfg, eng.params,
                                   rope, list(s['prompt'].encode()),
                                   p['want'], s['tokens'], p['at'])})
    del eng, reqs
    torch.cuda.empty_cache()
    return wrong, ties


def replica_sweeps(torch, card: str):
    """5i: ``bench_ttft``'s coldstart boots of the replica at SWEEP_REPLICA
    against a fresh ``--compile-cache-dir`` (never the default ``_build/``
    the other phases use). Boot 1 must compile (and add to the directory)
    the library of every kernel source the replica launches, boot 2 none,
    the libraries' mtimes unchanged; both must answer a fixed greedy prompt
    with the same tokens. Against boot 2: phase 5's speculation check
    (repetitive prompts led by their own continuation, so that the drafter
    proposes and verify runs: the sweep's template prompts draft nothing on
    random 8B weights), one ``speculative`` level (8 in flight,
    ``bit_identical``), one ``tenants`` level (3 s of trace, both tenants
    served) and one ``chaos-resume`` level (16 requests at 4 in flight:
    every stream completed, every spliced stream bitwise an in-process
    engine's resume of it, ``resume_check``, and every stream that parted
    from its uninterrupted twin parted at a near-tie, ``parting_tie``
    within RESUME_TIE_STEPS bf16 steps); decode,
    prefill, verify and ``qdot_int8`` must have launched in those runs
    (their counts, from 0 just before, are returned). Then the flight recorder's smoke twin on
    the card. Prints the boots' time to ready, their nvcc seconds, the
    sweep heads, and where a spliced stream parted from its uninterrupted
    twin, with the twin's top-2 logit margin there."""
    import random
    from skypilot_tpu_torch import bench_ttft
    from skypilot_tpu_torch.infer import server as server_lib
    vocab = server_lib.MODELS['8b']().vocab_size
    rnd = random.Random(SWEEP_PROMPT_SEED)
    prompt = [rnd.randrange(vocab) for _ in range(SWEEP_PROMPT_LEN)]
    args = bench_ttft.parse_args(['--sweep', 'coldstart', '--device',
                                  'cuda', '--boot-timeout', '600',
                                  *SWEEP_BENCH])
    device = torch.device('cuda', 0)

    def launches(base):
        _, raw = http_json(base + '/metrics')
        return json.loads(raw)['kernel_launches']

    def greedy(base):
        _, raw = http_json(base + '/generate', {
            'tokens': prompt, 'max_new_tokens': SWEEP_NEW})
        return json.loads(raw)['tokens']

    def sweeps(base):
        gen, met = base + '/generate', base + '/metrics'
        tokens = greedy(base)
        before = launches(base)
        spec = spec_check(base, vocab)
        bench_ttft.warm_speculative(gen, 8, 16, 64)
        speculative = bench_ttft.speculative_level(gen, met, 8, 16, 6, 64)
        tenants = bench_ttft.tenant_level(gen, met, 4, args.trace_seed, 3.0)
        chaos = bench_ttft.chaos_resume_level(gen, 4, 16, SWEEP_NEW,
                                              args.kill_after_chunks)
        after = launches(base)
        return {'tokens': tokens, 'spec_check': spec,
                'speculative': speculative, 'tenants': tenants,
                'chaos': chaos,
                'launches': {k: after[k] - before[k] for k in after}}

    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix='chip-smoke-kernels-') as cache:
        boots = []
        for i, then in enumerate((greedy, sweeps)):
            args.server_log = str(OUT_DIR / f'chip_smoke_coldstart_{i}.log')
            boots.append(bench_ttft.coldstart_boot(args, device, cache, i,
                                                   then, SWEEP_QUEUE))
    cold, warm = boots
    got = warm['then']
    spec, tenants, chaos = got['speculative'], got['tenants'], got['chaos']
    out = {
        'card': card, 'flags': SWEEP_REPLICA,
        'time_to_ready_s': [b['time_to_ready_s'] for b in boots],
        'first_token_s': [b['first_token_s'] for b in boots],
        'ready_ratio_cold_over_warm': (cold['time_to_ready_s']
                                       / warm['time_to_ready_s']),
        'nvcc_s': [b['nvcc_s'] for b in boots],
        'stamps': [b['stamps'] for b in boots],
        'libraries_added': [b['libraries_added'] for b in boots],
        'speculative': {k: spec.get(k) for k in (
            'accepted_len_mean', 'spec_accept_rate', 'tokens_per_step',
            'itl_improvement_x', 'bit_identical', 'counters')},
        'spec_check_accept_rate': got['spec_check']['spec_accept_rate'],
        'tenants': {'victim_ttft_p99_s': tenants['tenants'].get(
            'victim', {}).get('ttft_p99_s'), **{k: tenants[k] for k in (
                'samples', 'tenants', 'replica_requests_shed')}},
        'chaos_resume': {k: chaos.get(k) for k in (
            'completed_rate', 'resumes', 'resume_added_p99_s',
            'bit_identical')} | {'parted': [
                (p['request'], p['at']) for p in chaos['parted']]},
        'launches': got['launches']}
    print('replica sweeps (Llama-3-8B, int8 weights, random, ' + card
          + '): ' + json.dumps(out), flush=True)
    sources = server_lib.replica_sources(
        server_lib.parse_args(['--port', '0', *SWEEP_REPLICA]))
    if len(sources) != 3:
        fail(f'the replica should compile three kernel sources: {sources}')
    for src in sources:
        if not any(n.startswith(src + '-') for n in cold['libraries_added']) \
                or src not in cold['nvcc_s']:
            fail(f'boot 1 did not compile {src} into the fresh directory: '
                 f'{cold["libraries_added"]}, {cold["nvcc_s"]}')
    if warm['libraries_added'] or warm['nvcc_s'] \
            or warm['library_mtimes_after'] != warm['library_mtimes_before'] \
            or warm['library_mtimes_before'] != cold['library_mtimes_after']:
        fail(f'boot 2 compiled or touched a library: {warm["nvcc_s"]}, '
             f'{warm["library_mtimes_before"]} -> '
             f'{warm["library_mtimes_after"]}')
    if {cold['kernel_build_dir'], warm['kernel_build_dir']} \
            != {str(pathlib.Path(cache).resolve())}:
        fail(f'the replica did not build in --compile-cache-dir: '
             f'{cold["kernel_build_dir"]}, {warm["kernel_build_dir"]}')
    if cold['then'] != got['tokens']:
        fail(f'the two boots answered the fixed prompt differently: '
             f'{cold["then"][:8]} vs {got["tokens"][:8]}')
    if not spec['bit_identical']:
        fail(f'the speculative level: {json.dumps(spec)[:2000]}')
    served = tenants['tenants']
    if set(served) != {'victim', 'aggressor'} \
            or not served['victim']['ttft_p99_s']:
        fail(f'the tenants level did not serve both tenants: {served}')
    if chaos['completed_rate'] != 1.0 or not chaos['resumes']:
        fail(f'the chaos-resume level: {json.dumps(chaos)[:2000]}')
    wrong, ties = resume_check(torch, chaos)
    print(f'chaos-resume: {len(chaos["spliced"])} spliced streams, cut at '
          f'{[p["cut_at"] for p in chaos["spliced"]]} tokens, each '
          f'bitwise the in-process engine\'s resume: {not wrong}; '
          f'{len(ties)} parted from their uninterrupted twin, where, the '
          f'two tokens, the twin\'s top logit there and the gap from it to '
          f'the lower of the two, in bf16 steps of the top logit too ('
          + card + '): ' + json.dumps(ties), flush=True)
    if wrong:
        fail(f'a spliced stream differs from the engine\'s own resume: '
             f'{json.dumps(wrong)[:2000]}')
    wide = [t for t in ties if t['bf16_steps'] > RESUME_TIE_STEPS]
    if wide:
        fail(f'{len(wide)} spliced streams parted from their uninterrupted '
             f'twins away from a near-tie (a token more than '
             f'{RESUME_TIE_STEPS} bf16 steps below the top logit): '
             f'{json.dumps(wide)}')
    for name in SWEEP_KERNELS:
        if got['launches'].get(name, 0) <= 0:
            fail(f'{name} was not launched by the sweeps: {got["launches"]}')
    run = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.observability.stepline'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(run.stdout.strip(), flush=True)
    if run.returncode != 0 or 'profile-smoke OK' not in run.stdout:
        fail(f'the profile smoke exited {run.returncode}:\n'
             f'{run.stdout[-2000:]}\n{run.stderr[-4000:]}')
    return got['launches']


def _kernel_kind(name: str) -> str:
    low = name.lower()
    if 'paged_prefill_kernel' in low:
        return 'paged_prefill_attention'
    if 'qdot_int8_kernel' in low:
        return 'qdot_int8'
    if 'paged_attention_kernel' in low:
        return 'paged_decode_attention'
    if any(k in low for k in ('gemm', 'gemv', 'xmma', 'cutlass', 'cublas',
                              'nvjet')):
        return 'matmul'
    if 'memcpy' in low or 'memset' in low:
        return 'copy'
    return 'other'


class RepeatDrafter:
    """Drafts k copies of the context's last token: every step with it
    is a verify step (random weights rarely accept, which does not change
    what the step launches)."""

    def propose(self, context, k, memo=None):
        del memo
        return [context[-1]] * k


# Launch calls a step makes from the host, by CUDA API name in the
# profiler's trace: kernels one by one, or a whole CUDA graph at once.
LAUNCH_APIS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
               'cuLaunchKernelEx', 'cudaGraphLaunch')


def profile_decode(torch, pa, card: str, kv_dtype: str, verify: bool,
                   graphs: bool, depth: int, quantize: bool = False,
                   paged: bool = True, slots: int = 8) -> None:
    """An in-process 8B engine (``kv_dtype`` pages, or with ``paged``
    False the dense cache; pipeline ``depth``,
    the step's CUDA graph on or off) with all ``slots`` slots at PROFILE_PROMPT
    tokens of context, stepping decode steps or (``verify``, spec_k
    VERIFY_R - 1 with :class:`RepeatDrafter`) verify steps: the
    host-clock time of a step over PROFILE_STEPS steps (and, for eager
    bf16 decode, over as many with the dense block one row wide instead
    of ``STEP_ROWS``: what the padding that keeps decode and verify
    steps bitwise alike costs), then the synchronizing CUDA calls of one
    step, then ``torch.profiler`` over a few more: device time by kernel,
    the paged decode/verify kernel's time and launches (by the profiler
    and by the wrapper's counter, which counts a graph's launches once
    per replay), the launch calls the host makes, the device's busy
    share of the window, and the host ops with the most self time."""
    import random
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import server as server_lib
    eng = server_lib.build_engine('8b', slots, MAX_SEQ, PAGE, None, 'cuda',
                                  paged=paged, kv_dtype=kv_dtype,
                                  spec_k=VERIFY_R - 1 if verify else 0,
                                  pipeline_depth=depth, cuda_graphs=graphs,
                                  quantize=quantize)
    if verify:
        eng._drafter = RepeatDrafter()
    slots, vocab = eng.ecfg.n_slots, eng.config.vocab_size
    rnd = random.Random(2)
    for _ in range(slots):
        eng.submit([rnd.randrange(vocab) for _ in range(PROFILE_PROMPT)],
                   max_new_tokens=200)
    while eng.metrics()['prefill_tokens'] < slots * PROFILE_PROMPT:
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    narrow_ms = None
    if kv_dtype == 'bfloat16' and not verify and not graphs \
            and not quantize and paged:
        rows, model_lib.STEP_ROWS = model_lib.STEP_ROWS, 1
        try:
            eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            narrow_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
        finally:
            model_lib.STEP_ROWS = rows
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    n = 5
    spec_before = eng.metrics().get('spec_steps', 0)
    wrapper_before = dict(pa.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spec_steps = eng.metrics().get('spec_steps', 0) - spec_before
    wrapper = sum(pa.launches[k] - wrapper_before[k] for k in pa.launches)
    if verify and spec_steps != n:
        fail(f'the verify-step profile ran {spec_steps} verify steps of {n}')
    kernels, host_ops, api = {}, {}, {}
    for e in prof.key_averages():
        if e.key in LAUNCH_APIS:
            api[e.key] = e.count / n
        us = getattr(e, 'self_device_time_total', 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels[e.key] = (us / 1e3 / n, e.count / n)
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            host_ops[e.key] = (e.self_cpu_time_total / 1e3 / n, e.count / n)
    busy = sum(ms for ms, _ in kernels.values())
    kinds = {}
    for name, (ms, _) in kernels.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0) + ms
    attn = [(ms, c) for name, (ms, c) in kernels.items()
            if _kernel_kind(name) == 'paged_decode_attention']
    qdot = [(ms, c) for name, (ms, c) in kernels.items()
            if _kernel_kind(name) == 'qdot_int8']
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:15]
    step = 'verify' if verify else 'decode'
    print(f'{step} step profile (Llama-3-8B, '
          f'{"int8 weights, " if quantize else ""}{kv_dtype} '
          f'{"pages" if paged else "dense cache"}, {slots} slots '
          f'at {PROFILE_PROMPT} tokens'
          + (f', spec_k {VERIFY_R - 1}' if verify else '')
          + f', depth {depth}, CUDA graphs {"on" if graphs else "off"}, '
          f'{card}): ' + json.dumps({
              'pipeline_depth': depth, 'cuda_graphs': graphs,
              'step_programs': eng.compiled_counts(),
              'step_ms': step_ms,
              'step_ms_one_row_block': narrow_ms,
              'synchronizing_calls_per_step': sorted(
                  {str(w.message)[:80] for w in syncs}) + [len(syncs)],
              'decode_tokens_per_sec': slots / step_ms * 1e3,
              'profiled_step_ms': window_ms / n,
              'device_busy_ms_per_step': busy,
              'device_busy_share': busy * n / window_ms,
              'device_busy_share_unprofiled': busy / step_ms,
              'kernel_launches_per_step': sum(c for _, c in kernels.values()),
              f'paged_{step}_kernel_ms_per_step': sum(ms for ms, _ in attn),
              f'paged_{step}_kernel_launches_per_step':
                  sum(c for _, c in attn),
              'paged_kernel_wrapper_count_per_step': wrapper / n,
              'qdot_int8_ms_per_step': sum(ms for ms, _ in qdot),
              'qdot_int8_launches_per_step': sum(c for _, c in qdot),
              'qdot_int8_share_of_busy': sum(ms for ms, _ in qdot) / busy,
              'host_launch_calls_per_step': api,
              'device_ms_per_step_by_kind': kinds,
              'top_kernels': [{'name': k[:100], 'ms_per_step': ms,
                               'launches_per_step': c}
                              for k, (ms, c) in top],
              # Host self time under the profiler (which inflates it).
              'top_host_ops': [{'name': k[:60], 'ms_per_step': ms,
                                'calls_per_step': c}
                               for k, (ms, c) in top_host],
              'max_memory_allocated_gb':
                  torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    del eng
    torch.cuda.empty_cache()


def profile_chunks(torch, pa, card: str, mixed: bool, graphs: bool) -> None:
    """Where a chunk's step time goes, 8B, bf16 pages: with ``mixed``, 7
    slots decoding at PROFILE_PROMPT tokens of context while a
    PROFILE_AGGRESSOR-token prompt prefills one 256-token chunk a step
    into the decode dispatch (fused mixed steps); without, that prompt
    alone, one standalone chunk a step. Eagerly at depth 0 or with the
    step's CUDA graph at depth 1: the host-clock time of a step over each
    of PROFILE_WINDOWS aggressors' chunks (their median is ``step_ms``),
    then ``torch.profiler`` over another's: device busy time per step,
    kernel launches and the host's launch calls."""
    import random
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    eng = engine_lib.InferenceEngine(
        cfg, llama.init_params(cfg, gen, 'cuda'), engine_lib.EngineConfig(
            n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
            pipeline_depth=1 if graphs else 0, cuda_graphs=graphs,
            fused_prefill=mixed, prefill_chunks_per_step=1),
        seed=0, device='cuda')
    rnd = random.Random(3)
    vocab = cfg.vocab_size
    if mixed:
        for _ in range(7):
            eng.submit([rnd.randrange(vocab) for _ in range(PROFILE_PROMPT)],
                       max_new_tokens=1000)
        while eng.metrics()['prefill_tokens'] < 7 * PROFILE_PROMPT:
            eng.step()

    def aggressor():
        """Submit the aggressor. Its first chunks (all but the one that
        completes the prompt, whose step also decodes it) are timed."""
        eng.submit([rnd.randrange(vocab) for _ in range(PROFILE_AGGRESSOR)],
                   max_new_tokens=1)
        return PROFILE_AGGRESSOR // 256 - 1

    def finish():
        while eng.metrics()['num_active'] > (7 if mixed else 0):
            eng.step()

    for _ in range(2):                    # build and capture, off the clock
        aggressor()
        finish()
    windows = []
    for _ in range(PROFILE_WINDOWS):
        torch.cuda.synchronize()
        before = eng.metrics()['prefill_tokens']
        n = aggressor()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n * 1e3)
        if eng.metrics()['prefill_tokens'] - before != 256 * n:
            fail('the chunk profile did not prefill one chunk a step')
        finish()
    step_ms = statistics.median(windows)
    n = aggressor()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    finish()
    kernels, api = {}, {}
    for e in prof.key_averages():
        if e.key in LAUNCH_APIS:
            api[e.key] = e.count / n
        us = getattr(e, 'self_device_time_total', 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels[e.key] = (us / 1e3 / n, e.count / n)
    busy = sum(ms for ms, _ in kernels.values())
    kinds = {}
    for name, (ms, _) in kernels.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0) + ms
    step = 'mixed' if mixed else 'chunk'
    print(f'{step} step profile (Llama-3-8B, bf16 pages, '
          + ('7 slots decoding at ' + str(PROFILE_PROMPT) + ' tokens + '
             if mixed else '')
          + f'one 256-token chunk a step of a {PROFILE_AGGRESSOR}-token '
          f'prompt, depth {1 if graphs else 0}, CUDA graphs '
          f'{"on" if graphs else "off"}, {card}): ' + json.dumps({
              'cuda_graphs': graphs, 'step_programs': eng.compiled_counts(),
              'step_ms': step_ms, 'step_ms_windows': windows,
              'profiled_step_ms': window_ms / n,
              'device_busy_ms_per_step': busy,
              'device_busy_share': busy * n / window_ms,
              'device_busy_share_unprofiled': busy / step_ms,
              'kernel_launches_per_step': sum(c for _, c in kernels.values()),
              'host_launch_calls_per_step': api,
              'device_ms_per_step_by_kind': kinds}), flush=True)
    del eng
    torch.cuda.empty_cache()


def profile_recorder(torch, card: str) -> None:
    """The decode step with the flight recorder on and off: 8B, bf16
    pages, 8 slots at PROFILE_PROMPT tokens, depth 1 with the decode
    graph, host-clock step time over PROFILE_STEPS steps, on, off, on,
    off on two engines built once."""
    import random
    from skypilot_tpu_torch.infer import server as server_lib
    engines = {on: server_lib.build_engine('8b', 8, MAX_SEQ, PAGE, None,
                                           'cuda', paged=True, stepline=on)
               for on in (True, False)}
    rnd = random.Random(2)
    for eng in engines.values():
        for _ in range(8):
            eng.submit([rnd.randrange(eng.config.vocab_size)
                        for _ in range(PROFILE_PROMPT)], max_new_tokens=400)
        while eng.metrics()['prefill_tokens'] < 8 * PROFILE_PROMPT:
            eng.step()
        for _ in range(3):
            eng.step()
    times = {True: [], False: []}
    for _ in range(2):
        for on, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) / PROFILE_STEPS * 1e3)
    print(f'decode step, flight recorder on vs off (Llama-3-8B, bf16 pages, '
          f'8 slots at {PROFILE_PROMPT} tokens, depth 1, CUDA graphs on, '
          f'{card}): ' + json.dumps({
              'step_ms_recorder_on': times[True],
              'step_ms_recorder_off': times[False],
              'stepline_steps': engines[True].metrics()['stepline_steps'],
              'summary': engines[True].stepline_summary()}), flush=True)
    del engines
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3 + 4, training kernels
# ---------------------------------------------------------------------------
def compare(torch, got, want, rtol: float, atol_frac: float):
    """(max abs error, ok): ok when every element is within rtol of the
    plain value plus atol_frac of the plain tensor's largest
    magnitude."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all().item():
        return float('inf'), False
    err = (got - want).abs()
    limit = rtol * want.abs() + atol_frac * want.abs().max()
    return err.max().item(), bool((err <= limit).all().item())


def flash_inputs(torch, gen, b, hq, hkv, s, d):
    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device='cuda').to(torch.bfloat16)
    return randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d), \
        randn(b, hq, s, d)


def flash_check(torch, att, case, causal, block):
    """Every flash kernel output against its plain version on the same
    inputs; the backward takes the kernel forward's out and lse on both
    sides. Returns ({name: max abs error}, {name: ok}, (out, lse,
    delta))."""
    q, k, v, do = case
    scale = q.shape[-1] ** -0.5
    kw = dict(causal=causal, sm_scale=scale, block_k=block)
    out, lse = att._flash_forward(q, k, v, causal, scale, block)
    torch.cuda.synchronize()
    ref_out, ref_lse = att.flash_forward_reference(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)[:, :, None, :]
    dq = att._flash_backward_dq(q, k, v, do, lse, delta, causal, scale,
                                block)
    dk, dv = att._flash_backward_dkv(q, k, v, do, lse, delta, causal, scale,
                                     block)
    torch.cuda.synchronize()
    ref_dq = att.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    ref_dk, ref_dv = att.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 **kw)
    errs, oks = {}, {}
    for name, got, want, tol in (
            ('out', out, ref_out, (BF16_RTOL, BF16_ATOL_FRAC)),
            ('lse', lse, ref_lse, (FP32_RTOL, FP32_ATOL_FRAC)),
            ('dq', dq, ref_dq, (BF16_RTOL, BF16_ATOL_FRAC)),
            ('dk', dk, ref_dk, (BF16_RTOL, BF16_ATOL_FRAC)),
            ('dv', dv, ref_dv, (BF16_RTOL, BF16_ATOL_FRAC))):
        errs[name], oks[name] = compare(torch, got, want, *tol)
    return errs, oks, (out, lse, delta)


def ce_inputs(torch, gen, T, d, V):
    x = torch.randn((T, d), generator=gen, device='cuda').to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device='cuda')
         * d ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, V, (T,), generator=gen, device='cuda',
                      dtype=torch.int32)
    return x, w, t


def ce_check(torch, ce, case, block):
    x, w, t = case
    nll, lse = ce._fused_fwd(x, w, t, block)
    torch.cuda.synchronize()
    ref_nll, ref_lse = ce.fused_forward_reference(x, w, t, block)
    errs, oks = {}, {}
    for name, got, want in (('nll', nll, ref_nll), ('lse', lse, ref_lse)):
        errs[name], oks[name] = compare(torch, got, want, FP32_RTOL,
                                        FP32_ATOL_FRAC)
    return errs, oks


def check_training_kernels(torch, att, ce):
    """Phase 3, training kernels: at the bench_1b shapes, then at every
    variant the wrappers take on small inputs. Returns {kernel: (max abs
    error at the bench_1b shapes, inputs)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    case = flash_inputs(torch, gen, FB, FH, FH, FS, FD)
    errs, oks, saved = flash_check(torch, att, case, True, BLOCK)
    print(f'flash attention vs plain at b={FB} h={FH} s={FS} d={FD} causal: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bf16 outputs rtol 2^-7 + {BF16_ATOL_FRAC} x max, fp32 lse '
          f'rtol {FP32_RTOL} + {FP32_ATOL_FRAC} x max)', flush=True)
    bad = [k for k, ok in oks.items() if not ok]
    if bad:
        fail(f'flash kernels disagree with their plain versions at the '
             f'bench_1b shapes: {bad} {errs}')
    # No atomics anywhere: the backward gives the same bits every run.
    q, k, v, do = case
    _, lse, delta = saved
    args = (q, k, v, do, lse, delta, True, FD ** -0.5, BLOCK)
    runs = [(att._flash_backward_dq(*args), *att._flash_backward_dkv(*args))
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail('the flash backward kernels give different bits run to run')
    print('flash backward: dq, dk, dv bitwise equal over two runs',
          flush=True)
    del runs
    results = {
        'flash_attention_fwd': (max(errs['out'], errs['lse']), case, saved),
        'flash_attention_bwd_dq': (errs['dq'], case, saved),
        'flash_attention_bwd_dkv': (max(errs['dk'], errs['dv']), case, saved),
    }
    worst, n = {}, 0
    for hd in att.CUDA_HEAD_DIMS:
        for group in att.CUDA_GROUPS:
            for causal in (True, False):
                # s 192: three tiles, so not a multiple of 128.
                case = flash_inputs(torch, gen, 2, 2 * group, 2, 192, hd)
                errs, oks, _ = flash_check(torch, att, case, causal, 64)
                bad = [k for k, ok in oks.items() if not ok]
                if bad:
                    fail(f'flash kernels disagree with their plain versions '
                         f'at hd={hd} group={group} causal={causal}: {bad} '
                         f'{errs}')
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                n += 1
    print(f'all {n} flash variants vs plain: max abs error '
          + ', '.join(f'{k} {v:.3e}' for k, v in worst.items()), flush=True)

    case = ce_inputs(torch, gen, CE_T, CE_D, CE_V)
    errs, oks = ce_check(torch, ce, case, BLOCK)
    print(f'fused cross-entropy vs plain at T={CE_T} d={CE_D} V={CE_V}: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (rtol {FP32_RTOL} + {FP32_ATOL_FRAC} x max)', flush=True)
    if not all(oks.values()):
        fail(f'ce_fwd disagrees with its plain version: {errs}')
    results['fused_cross_entropy_fwd'] = (max(errs.values()), case, None)
    # The splits merge in a fixed order, without atomics: the same bits
    # every run.
    x, w, t = case
    runs = [ce._fused_fwd(x, w, t, BLOCK) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail('the cross-entropy kernel gives different bits run to run')
    print('fused cross-entropy: nll, lse bitwise equal over two runs',
          flush=True)
    del runs
    # V 1000 is not a multiple of the 256-column tile; T 100 not of 128;
    # T 5 and V 8 are smaller than one TMA box; targets in the last tile,
    # at V - 1 and outside the vocabulary, and on the first column of the
    # second split; vocabularies around the split edge; llama-350m's and
    # Llama-3's heads.
    shapes = [(100, 64, 1000), (64, 128, 256), (5, 64, 8)]
    shapes += [(200, 128, V) for V in ce_split_edges(ce)]
    shapes += [(4 * 2048, 1024, 32768), (512, 4096, 128256)]
    edge = ce.CE_BLOCK_V * ce.CE_TILES_PER_SPLIT
    for T, d, V in shapes:
        x, w, t = ce_inputs(torch, gen, T, d, V)
        t[:5] = torch.tensor([V - 1, (V - 100) % V, -1, V, edge % V],
                             dtype=torch.int32)
        errs, oks = ce_check(torch, ce, (x, w, t), BLOCK)
        print(f'fused cross-entropy vs plain at T={T} d={d} V={V}: '
              + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()),
              flush=True)
        if not all(oks.values()):
            fail(f'ce_fwd disagrees with its plain version at T={T} d={d} '
                 f'V={V}: {errs}')
    return results


def adamw_leaf(torch, gen, shape, dtype, mu_dtype):
    """A seeded (g, mu, nu, p) of one leaf on the card: moments as a few
    steps leave them (nu >= 0), params ~1."""
    def draw(scale, dt):
        return (torch.randn(shape, generator=gen, device='cuda') * scale
                ).to(dt)
    return (draw(1.0, dtype), draw(1e-2, mu_dtype),
            draw(1e-2, dtype).square_(), draw(1.0, dtype))


def adamw_scalars(torch, count):
    """The bias corrections and step size of train-4k's optimizer
    (``make_optimizer(learning_rate=3e-4, total_steps=1000)``) at
    ``count``, as ``AdamW.update`` makes them, and its optimizer."""
    from skypilot_tpu_torch.train import trainer
    opt = trainer.make_optimizer(learning_rate=3e-4, total_steps=1000)
    f32 = torch.float32
    bc1 = 1 - torch.tensor(opt.b1, dtype=f32) ** (count + 1)
    bc2 = 1 - torch.tensor(opt.b2, dtype=f32) ** (count + 1)
    step = torch.tensor(-opt.schedule(count), dtype=f32)
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay, grad_clip=opt.grad_clip)
    return (bc1, bc2, step), hyper


def check_adamw_kernel(torch):
    """Phase 3, the AdamW update: the kernel's mu, nu and p bitwise the
    eager chain's at the ft stage's w_gate (bf16, clip on, count 150),
    then at 1,000,003 elements (a ragged tail) for every (param, mu)
    dtype pair the trainer builds, clip on and off. Returns its entry of
    the checked kernels: the max abs error (0, or the phase fails) and
    the case."""
    from skypilot_tpu_torch.ops import adamw
    gen = torch.Generator(device='cuda')
    gen.manual_seed(21)
    (bc1, bc2, step), hyper = adamw_scalars(torch, 150)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(ADAMW_LEAVES['w_gate'], bf16, bf16, True)] + [
        ((1_000_003,), p_dt, m_dt, clip)
        for p_dt, m_dt in ((bf16, bf16), (f32, f32), (f32, bf16),
                           (bf16, f32)) for clip in (True, False)]
    for shape, p_dt, m_dt, clip in cases:
        leaf = adamw_leaf(torch, gen, shape, p_dt, m_dt)
        ref = [t.clone() for t in leaf]
        g_norm = torch.sqrt(torch.sum(leaf[0].float() ** 2)).to(p_dt)
        before = adamw.launches['adamw_update']
        adamw.adamw_update(*leaf, g_norm, clip, bc1, bc2, step, **hyper)
        if adamw.launches['adamw_update'] != before + 1:
            fail('adamw_update did not count its launch')
        adamw.adamw_update_reference(*ref, g_norm, clip, bc1, bc2, step,
                                     **hyper)
        torch.cuda.synchronize()
        for name, a, b in zip('gmvp', leaf, ref):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                fail(f'adamw_update: {name} differs from the eager chain at '
                     f'{shape} {p_dt} params, {m_dt} mu, clip {clip}')
        del leaf, ref
    torch.cuda.empty_cache()
    print(f'adamw_update: mu, nu and p bitwise the eager chain at {len(cases)} '
          f'cases (w_gate {ADAMW_LEAVES["w_gate"]} bf16; 1,000,003 '
          f'elements, every dtype pair, clip on and off)', flush=True)
    return {'adamw_update': (0.0, cases[0])}


def time_adamw_kernel(torch):
    """Phase 4, the AdamW update at train-4k's leaves (bf16): w_gate
    alone, then all of them; the kernel (one launch a leaf), the eager
    chain, and one ``torch._fused_adamw_`` call over the same leaves (a
    yardstick the port never calls), against 14 bytes an element at the
    card's bandwidth. Returns w_gate's row of the timed kernels."""
    from skypilot_tpu_torch.ops import adamw
    gen = torch.Generator(device='cuda')
    gen.manual_seed(22)
    (bc1, bc2, step), hyper = adamw_scalars(torch, 150)
    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    for label, names in (('w_gate', ['w_gate']),
                         ('whole update', list(ADAMW_LEAVES))):
        leaves = [adamw_leaf(torch, gen, ADAMW_LEAVES[n], bf16, bf16)
                  for n in names]
        n = sum(leaf[0].numel() for leaf in leaves)
        g_norm = torch.sqrt(sum(torch.sum(leaf[0].float() ** 2)
                                for leaf in leaves)).to(bf16)

        def kernel():
            for leaf in leaves:
                adamw.adamw_update(*leaf, g_norm, True, bc1, bc2, step,
                                   **hyper)

        def plain():
            for leaf in leaves:
                adamw.adamw_update_reference(*leaf, g_norm, True, bc1, bc2,
                                             step, **hyper)
        reps = 20 if len(names) == 1 else 5
        ms = time_ms(torch, kernel, reps, flush)
        plain_ms = time_ms(torch, plain, 3, flush)
        steps = [torch.tensor(151.0, device='cuda') for _ in leaves]
        try:
            lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
                [x[3] for x in leaves], [x[0] for x in leaves],
                [x[1] for x in leaves], [x[2] for x in leaves], [], steps,
                lr=3e-4, beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                amsgrad=False, maximize=False), reps, flush)
        except (RuntimeError, TypeError) as e:
            lib_ms = None
            print(f'  torch._fused_adamw_: not measured ({e})', flush=True)
        bound_ms = ADAMW_BYTES_PER_ELEMENT * n / HBM_BYTES_PER_S * 1e3
        rate = ADAMW_BYTES_PER_ELEMENT * n / (ms * 1e-3)
        print(f'adamw_update, {label} ({n:,} bf16 elements, {len(leaves)} '
              f'launches): {ms:.4f} ms ({rate / 1e12:.3f} TB/s, '
              f'{100 * rate / HBM_BYTES_PER_S:.1f}% of peak), plain '
              f'{plain_ms:.4f} ms, library '
              + (f'{lib_ms:.4f} ms' if lib_ms is not None else 'not measured')
              + f', bound {bound_ms:.4f} ms (bytes)', flush=True)
        rows.setdefault('adamw_update', dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound=(bound_ms, 'bytes')))
        del leaves, steps
        torch.cuda.empty_cache()
    return rows


def time_training_kernels(torch, att, ce, checked):
    """Phase 4, training kernels at the bench_1b shapes."""
    F = torch.nn.functional
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    q, k, v, do = checked['flash_attention_fwd'][1]
    out, lse, delta = checked['flash_attention_fwd'][2]
    scale = FD ** -0.5
    kw = dict(causal=True, sm_scale=scale, block_k=BLOCK)
    pairs = FS * (FS + 1) // 2          # causal (query, key) pairs per head
    elems = FB * FH * FS * FD           # one [b, h, s, d] tensor (hkv = hq)
    rows_f32 = FB * FH * FS             # one [b, h, 1, s] fp32 tensor
    flops_1 = 2.0 * FB * FH * FD * pairs     # one s x s x d product, causal

    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20, flush)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True), 20, flush)
    rows['flash_attention_fwd'] = dict(
        ms=time_ms(torch, lambda: att._flash_forward(
            q, k, v, True, scale, BLOCK), 20, flush),
        plain_ms=time_ms(torch, lambda: att.flash_forward_reference(
            q, k, v, **kw), 5, flush),
        library_ms=lib_fwd,
        bound=bound(4 * elems * 2 + rows_f32 * 4, 2 * flops_1))
    rows['flash_attention_bwd_dq'] = dict(
        ms=time_ms(torch, lambda: att._flash_backward_dq(
            q, k, v, do, lse, delta, True, scale, BLOCK), 20, flush),
        plain_ms=time_ms(torch, lambda: att.flash_bwd_dq_reference(
            q, k, v, do, lse, delta, **kw), 5, flush),
        library_ms=lib_bwd,
        bound=bound(5 * elems * 2 + 2 * rows_f32 * 4, 3 * flops_1))
    rows['flash_attention_bwd_dkv'] = dict(
        ms=time_ms(torch, lambda: att._flash_backward_dkv(
            q, k, v, do, lse, delta, True, scale, BLOCK), 20, flush),
        plain_ms=time_ms(torch, lambda: att.flash_bwd_dkv_reference(
            q, k, v, do, lse, delta, **kw), 5, flush),
        library_ms=lib_bwd,
        bound=bound(6 * elems * 2 + 2 * rows_f32 * 4, 4 * flops_1))
    del lib_out, qg, kg, vg

    x, w, t = checked['fused_cross_entropy_fwd'][1]

    def library_ce():
        logits = torch.matmul(x, w).float()
        return torch.logsumexp(logits, -1) - logits.gather(
            1, t.long()[:, None])[:, 0]

    rows['fused_cross_entropy_fwd'] = dict(
        ms=time_ms(torch, lambda: ce._fused_fwd(x, w, t, BLOCK), 10, flush),
        plain_ms=time_ms(torch, lambda: ce.fused_forward_reference(
            x, w, t, BLOCK), 5, flush),
        library_ms=time_ms(torch, library_ce, 10, flush),
        bound=bound(x.numel() * 2 + w.numel() * 2 + CE_T * 4 * 3,
                    2.0 * CE_T * CE_D * CE_V))
    for name, r in rows.items():
        print(f'{name}: {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, '
              f'library {r["library_ms"]:.4f} ms, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})', flush=True)
    print('(library: scaled_dot_product_attention forward; its autograd '
          'backward computes dq, dk and dv together and stands beside both '
          'backward kernels; matmul + logsumexp for the cross-entropy)',
          flush=True)
    return rows


def check_tp_training_kernels(torch, att):
    """Phase 3 at a tensor-parallel training rank's heads
    (``FLASH_TP_SHAPES``), at phase 7e's ring blocks (``FLASH_RING_SHAPES``)
    and at 7f's and 7g's attention shapes (``FLASH_PATH_SHAPES``): flash
    forward, dQ and dK/dV against their plain versions. Returns {label:
    (errors, inputs, (out, lse, delta), causal)} for phase 4."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    checked = {}
    cases = [(label, shape, True) for label, shape in
             {**FLASH_TP_SHAPES, **FLASH_PATH_SHAPES}.items()]
    cases += [(label, shape, causal)
              for label, (shape, causal) in FLASH_RING_SHAPES.items()]
    for label, (b, hq, hkv, s, d), causal in cases:
        case = flash_inputs(torch, gen, b, hq, hkv, s, d)
        errs, oks, saved = flash_check(torch, att, case, causal, BLOCK)
        print(f'flash attention vs plain at {label} (b={b} hq={hq} hkv={hkv} '
              f's={s} d={d} causal={causal}): '
              + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()),
              flush=True)
        bad = [k for k, ok in oks.items() if not ok]
        if bad:
            fail(f'flash kernels disagree with their plain versions at '
                 f'{label}: {bad} {errs}')
        checked[label] = (errs, case, saved, causal)
    return checked


def time_flash(torch, att, case, saved, flush, causal=True):
    """Phase 4, the three flash kernels on one case (any GQA group, causal
    or not), each beside its plain version, SDPA (its autograd backward
    for both backward kernels) and its bound."""
    F = torch.nn.functional
    q, k, v, do = case
    out, lse, delta = saved
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale, block_k=BLOCK)
    q_el, kv_el, rows_f32 = b * hq * s * d, b * hkv * s * d, b * hq * s
    pairs = s * (s + 1) // 2 if causal else s * s
    flops_1 = 2.0 * b * hq * d * pairs      # one s x s x d product
    gqa = {'enable_gqa': True} if hkv != hq else {}
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, **gqa), 20, flush)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             **gqa)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True), 20, flush)
    del lib_out, qg, kg, vg
    args = (q, k, v, do, lse, delta)
    return {
        'flash_attention_fwd': dict(
            ms=time_ms(torch, lambda: att._flash_forward(
                q, k, v, causal, scale, BLOCK), 20, flush),
            plain_ms=time_ms(torch, lambda: att.flash_forward_reference(
                q, k, v, **kw), 5, flush),
            library_ms=lib_fwd,
            bound=bound((2 * q_el + 2 * kv_el) * 2 + rows_f32 * 4,
                        2 * flops_1)),
        'flash_attention_bwd_dq': dict(
            ms=time_ms(torch, lambda: att._flash_backward_dq(
                *args, causal, scale, BLOCK), 20, flush),
            plain_ms=time_ms(torch, lambda: att.flash_bwd_dq_reference(
                *args, **kw), 5, flush),
            library_ms=lib_bwd,
            bound=bound((3 * q_el + 2 * kv_el) * 2 + 2 * rows_f32 * 4,
                        3 * flops_1)),
        'flash_attention_bwd_dkv': dict(
            ms=time_ms(torch, lambda: att._flash_backward_dkv(
                *args, causal, scale, BLOCK), 20, flush),
            plain_ms=time_ms(torch, lambda: att.flash_bwd_dkv_reference(
                *args, **kw), 5, flush),
            library_ms=lib_bwd,
            bound=bound((2 * q_el + 4 * kv_el) * 2 + 2 * rows_f32 * 4,
                        4 * flops_1)),
    }


def time_tp_training_kernels(torch, att, tp_checked):
    """Phase 4 at the tensor-parallel training ranks' heads (rows 5t and
    6t of PERF.md's kernel table), at phase 7e's ring blocks (rows 5r and
    6r) and at 7f's and 7g's attention shapes (rows 5p and 6p)."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    timed = {}
    for label, (errs, case, saved, causal) in tp_checked.items():
        rows = time_flash(torch, att, case, saved, flush, causal)
        for name, r in rows.items():
            print(f'{name} at {label}: {r["ms"]:.4f} ms, plain '
                  f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} '
                  f'ms, bound {r["bound"][0]:.4f} ms ({r["bound"][1]})',
                  flush=True)
        timed[label] = rows
    return timed


# ---------------------------------------------------------------------------
# Phase 6: the training slice against its plain path
# ---------------------------------------------------------------------------
def check_slice(torch, att, ce):
    """loss_fn and every gradient of a 2-layer bench_1b-width model, the
    kernel path (flash + fused CE) against the plain path (dense
    attention + dense CE), same bf16 params and batch."""
    from skypilot_tpu_torch.models import llama
    cfg_k = llama.LlamaConfig.bench_1b(n_layers=2, attention_impl='flash',
                                       fused_loss=True)
    cfg_p = llama.LlamaConfig.bench_1b(n_layers=2, attention_impl='dense',
                                       fused_loss=False)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(2)
    params = llama.init_params(cfg_k, gen, 'cuda')
    tokens = torch.randint(0, cfg_k.vocab_size, (1, FS + 1), generator=gen,
                           device='cuda', dtype=torch.int32)
    leaves = [(f'layers.{k}', t) for k, t in params['layers'].items()] + [
        (k, params[k]) for k in ('embed', 'final_norm', 'lm_head')]
    for _, t in leaves:
        t.requires_grad_(True)

    def run(cfg):
        att.reset_launches()
        ce.reset_launches()
        loss = llama.loss_fn(cfg, params, tokens[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
        return loss.item(), grads, {**att.launches, **ce.launches}

    loss_k, grads_k, launches_k = run(cfg_k)
    loss_p, grads_p, launches_p = run(cfg_p)
    if any(launches_k[k] <= 0 for k in TRAINING_KERNELS) \
            or any(launches_p.values()):
        fail(f'the kernel path must launch every training kernel and the '
             f'plain path none: {launches_k} / {launches_p}')
    rel = {}
    for (name, _), gk, gp in zip(leaves, grads_k, grads_p):
        rel[name] = ((gk.float() - gp.float()).norm()
                     / gp.float().norm()).item()
    summary = {'loss_kernels': loss_k, 'loss_plain': loss_p,
               'loss_abs_diff': abs(loss_k - loss_p),
               'grad_rel_norm_err': rel, 'launches': launches_k}
    print('slice vs plain path (2 layers at bench_1b width, b 1, s 2048, '
          f'loss atol {SLICE_LOSS_ATOL}, grads rel-norm '
          f'{SLICE_GRAD_RTOL}): ' + json.dumps(summary), flush=True)
    if not abs(loss_k - loss_p) <= SLICE_LOSS_ATOL \
            or not all(r <= SLICE_GRAD_RTOL for r in rel.values()):
        fail('the kernel path disagrees with the plain path')
    for _, t in leaves:
        t.requires_grad_(False)
    return summary


def check_remat(torch, att, ce):
    """Phase 6b: ``loss_fn``'s gradients under the ``save_attn`` and
    ``dots`` remat policies against ``full``'s (2 layers at bench_1b
    width, b 1, s 2048, flash + fused CE, the same bf16 params), each leaf
    by relative norm within REMAT_GRAD_RTOL (bitwise leaves counted), and
    the flash forward's launches: 2 a layer under ``full`` and ``dots``
    (the forward and its recompute), 1 under ``save_attn``."""
    from skypilot_tpu_torch.models import llama
    gen = torch.Generator(device='cuda')
    gen.manual_seed(2)
    kw = dict(n_layers=2, attention_impl='flash', fused_loss=True)
    params = llama.init_params(llama.LlamaConfig.bench_1b(**kw), gen, 'cuda')
    tokens = torch.randint(0, 32768, (1, FS + 1), generator=gen,
                           device='cuda', dtype=torch.int32)
    leaves = [(f'layers.{k}', t) for k, t in params['layers'].items()] + [
        (k, params[k]) for k in ('embed', 'final_norm', 'lm_head')]
    for _, t in leaves:
        t.requires_grad_(True)
    runs = {}
    for policy in ('full', 'save_attn', 'dots'):
        cfg = llama.LlamaConfig.bench_1b(remat_policy=policy, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launches()
        ce.reset_launches()
        loss = llama.loss_fn(cfg, params, tokens[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
        runs[policy] = (loss.item(), grads, dict(att.launches),
                        torch.cuda.max_memory_allocated() / 1e9)
    for _, t in leaves:
        t.requires_grad_(False)
    loss_f, grads_f, _, _ = runs['full']
    summary, checks = {}, []
    for policy, (loss, grads, launches, peak) in runs.items():
        rel = {name: ((g.float() - gf.float()).norm()
                      / gf.float().norm()).item()
               for (name, _), g, gf in zip(leaves, grads, grads_f)}
        bitwise = [name for (name, _), g, gf in zip(leaves, grads, grads_f)
                   if torch.equal(g, gf)]
        summary[policy] = {'loss': loss, 'loss_bitwise': loss == loss_f,
                           'bitwise_leaves': len(bitwise),
                           'max_grad_rel_norm_err': max(rel.values()),
                           'launches': launches, 'peak_memory_gb': peak}
        want = 1 if policy == 'save_attn' else 2
        if launches['flash_attention_fwd'] != want * kw['n_layers']:
            checks.append(f'{policy}: {launches["flash_attention_fwd"]} '
                          f'flash forward launches, want {want} a layer')
        if max(rel.values()) > REMAT_GRAD_RTOL or abs(loss - loss_f) > 0:
            checks.append(f'{policy}: loss {loss} vs {loss_f}, grads {rel}')
    print(f'remat policies vs full (2 layers at bench_1b width, b 1, s {FS}, '
          f'flash + fused CE; {len(leaves)} leaves): '
          + json.dumps(summary), flush=True)
    if checks:
        fail('phase 6b: ' + '; '.join(checks))
    return summary


def spawn_ranks(target, world: int, args: tuple, timeout: float,
                label: str) -> None:
    """``target(rank, world, address, *args)`` in ``world`` spawned
    processes at a free localhost port; fails unless every one exits 0
    within ``timeout`` seconds (one still alive then is killed)."""
    import torch.multiprocessing as mp
    from skypilot_tpu_torch.parallel import mesh
    address = f'127.0.0.1:{mesh.free_port()}'
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=target, args=(r, world, address) + args)
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * world:
        fail(f'{label}: rank exit codes {codes}')


def train_mesh_rank(rank: int, world: int, address: str, argv,
                    tmp: str) -> None:
    """One rank of phase 7c (a spawned process): ``train.run``'s rank
    program at fsdp 2 x tp 2 on cuda:0 over gloo, its kernel counters set
    to 0 just before; writes its logged steps, launches and peak memory to
    ``<tmp>/rank<rank>.json``."""
    import torch
    from skypilot_tpu_torch.ops import adamw
    from skypilot_tpu_torch.ops import attention as att
    from skypilot_tpu_torch.ops import cross_entropy as ce
    from skypilot_tpu_torch.parallel import mesh
    from skypilot_tpu_torch.train import run
    args = run.parse_args(argv)
    att.reset_launches()
    ce.reset_launches()
    adamw.reset_launches()
    logged = run.run_rank(args, mesh.MeshShape(1, 2, 2), rank, address,
                          'cuda:0', backend='gloo')
    torch.cuda.synchronize()
    pathlib.Path(tmp, f'rank{rank}.json').write_text(json.dumps({
        'logged': logged,
        'launches': {**att.launches, **ce.launches, **adamw.launches},
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}))


def train_mesh_on_one_card(torch, card: str):
    """Phase 7c: ``train.run``'s rank program for llama-350m (seq 512,
    batch 4, 3 steps, a checkpoint at steps 1 and 2) on 4 gloo ranks
    sharing the card at fsdp 2 x tp 2 (the backend named: a correctness
    run, every collective staged through the host) against the one-rank
    run: every rank's losses within MESH_LOSS_ATOL of it, the flash
    kernels launched on every rank; then the mesh's step-2 checkpoint
    resumed at one rank lands on the mesh's step 3 loss. Prints the time
    a step, labelled gloo on one card. Returns the launches summed over
    the ranks."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh
    from skypilot_tpu_torch.train import run
    t0 = time.perf_counter()
    # Each rank updates its block of every leaf once a step.
    updates = (train_leaves(llama.LlamaConfig.bench_350m())
               * int(MESH_ARGS[MESH_ARGS.index('--steps') + 1]))
    one = run.run_rank(run.parse_args(MESH_ARGS), mesh.MeshShape(), 0,
                       None, 'cuda')
    control = run.run_rank(run.parse_args(MESH_ARGS + ['--lr', '0']),
                           mesh.MeshShape(), 0, None, 'cuda')
    torch.cuda.empty_cache()
    checks = []
    control_err = max(abs(c['loss'] - o['loss'])
                      for c, o in zip(control, one, strict=True))
    if control_err <= MESH_CONTROL_X * MESH_LOSS_ATOL:
        checks.append(f'the lr 0 control parts from one rank by only '
                      f'{control_err}: the losses cannot show an update')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mesh_') as tmp:
        ckpt = os.path.join(tmp, 'ckpt')
        argv = MESH_ARGS + ['--checkpoint-dir', ckpt]
        spawn_ranks(train_mesh_rank, 4, (argv, tmp), 900, 'phase 7c')
        ranks = [json.loads(pathlib.Path(tmp, f'rank{r}.json').read_text())
                 for r in range(4)]
        saved = sorted(os.listdir(ckpt))
        resumed = run.run_rank(run.parse_args(argv), mesh.MeshShape(), 0,
                               None, 'cuda')
        torch.cuda.empty_cache()
    want = {r['step']: r['loss'] for r in one}
    mesh_err = max(abs(r['loss'] - want[r['step']])
                   for res in ranks for r in res['logged']
                   if r['step'] in want)
    launches = {}
    for i, res in enumerate(ranks):
        got = {r['step']: r['loss'] for r in res['logged']}
        if sorted(got) != sorted(want) or any(
                abs(got[k] - want[k]) > MESH_LOSS_ATOL for k in want):
            checks.append(f'rank {i} losses {got} vs one rank {want}')
        missing = [k for k in FLASH_KERNELS if res['launches'][k] <= 0]
        if missing:
            checks.append(f'rank {i}: {missing} not launched '
                          f'({res["launches"]})')
        if res['launches']['adamw_update'] != updates:
            checks.append(f'rank {i}: adamw_update launched '
                          f'{res["launches"]["adamw_update"]} times, want '
                          f'one a leaf a step ({updates})')
        for k, n in res['launches'].items():
            launches[k] = launches.get(k, 0) + n
    mesh3 = {r['step']: r['loss'] for r in ranks[0]['logged']}.get(3)
    if [r['step'] for r in resumed] != [3] or mesh3 is None \
            or abs(resumed[0]['loss'] - mesh3) > MESH_LOSS_ATOL:
        checks.append(f'the step-2 checkpoint resumed at one rank logged '
                      f'{resumed}, the mesh step 3 {mesh3}')
    if saved != ['1', '2']:
        checks.append(f'checkpoints {saved}, want steps 1 and 2')
    tokens = 4 * 512
    summary = {
        'card': card, 'mesh': 'dp 1 x fsdp 2 x tp 2, 4 gloo ranks on one '
        'card', 'one_rank': one, 'mesh_rank0': ranks[0]['logged'],
        'control_lr0': control, 'mesh_max_abs_err': mesh_err,
        'control_max_abs_err': control_err,
        'mesh_loss_atol': MESH_LOSS_ATOL,
        'resumed_at_one_rank': resumed, 'checkpoints': saved,
        'launches_per_rank': [r['launches'] for r in ranks],
        'peak_memory_gb_per_rank': [r['peak_memory_gb'] for r in ranks],
        'wall_s': time.perf_counter() - t0}
    print('phase 7c (train.run rank program, llama-350m, seq 512, batch 4, '
          f'lr 0.02, {card}): ' + json.dumps(summary), flush=True)
    print(f'  losses: mesh vs one rank {mesh_err:.6g}, the lr 0 control vs '
          f'one rank {control_err:.6g} (MESH_LOSS_ATOL {MESH_LOSS_ATOL})',
          flush=True)
    for r in ranks[0]['logged'][1:]:
        print(f'  fsdp 2 x tp 2 step {r["step"]}: '
              f'{tokens / r["tokens_per_s"] * 1e3:.1f} ms a step (gloo on '
              f'one card, not a speed number; one rank: '
              f'{tokens / one[r["step"] - 1]["tokens_per_s"] * 1e3:.1f} ms)',
              flush=True)
    if checks:
        fail('phase 7c: ' + '; '.join(checks))
    return launches


def vision_rank(rank: int, world: int, address: str, argv,
                tmp: str) -> None:
    """One rank of phase 7d (a spawned process): ``run_vision``'s rank
    program on cuda:0 over gloo; writes its logged steps."""
    from skypilot_tpu_torch.train import run_vision
    out = run_vision.run_rank(run_vision.parse_args(argv), world, rank,
                              address, 'cuda:0', backend='gloo')
    pathlib.Path(tmp, f'rank{rank}.json').write_text(
        json.dumps(out['logged']))


def vision_ddp_on_one_card(torch, card: str):
    """Phase 7d: ``run_vision``'s rank program (ResNet-50, bf16, batch 32
    at 224, 3 steps) at dp 2, two gloo ranks sharing the card, against
    one rank: the first loss within 1e-2, the later ones within
    VISION_LOSS_RTOL. Prints images/s, labelled gloo on one card."""
    from skypilot_tpu_torch.train import run_vision
    t0 = time.perf_counter()
    one = run_vision.run_rank(run_vision.parse_args(VISION_ARGS), 1, 0,
                              None, 'cuda')['logged']
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_vision_') as tmp:
        spawn_ranks(vision_rank, 2, (VISION_ARGS, tmp), 600, 'phase 7d')
        ranks = [json.loads(pathlib.Path(tmp, f'rank{r}.json').read_text())
                 for r in range(2)]
    summary = {'card': card, 'one_rank': one, 'dp2': ranks,
               'wall_s': time.perf_counter() - t0}
    print('phase 7d (run_vision rank program, ResNet-50, batch 32 at 224, '
          f'dp 2 as 2 gloo ranks on one card, {card}): '
          + json.dumps(summary), flush=True)
    print(f'  dp 2: {ranks[0][-1]["images_per_s"]:.1f} images/s (gloo on one '
          f'card, not a speed number); one rank: '
          f'{one[-1]["images_per_s"]:.1f}', flush=True)
    for res in ranks:
        for got, want in zip(res, one, strict=True):
            tol = 1e-2 if got['step'] == 1 else VISION_LOSS_RTOL
            if abs(got['loss'] - want['loss']) > tol * abs(want['loss']):
                fail(f'phase 7d: dp 2 loss {got} vs one rank {want}')
    return summary


# ---------------------------------------------------------------------------
# Phases 7e-7g: sequence, pipeline and expert parallelism, gloo ranks on
# the one card
# ---------------------------------------------------------------------------
def gpu_seconds(torch, fn, reps: int) -> float:
    """Median seconds of ``fn()`` on the host's clock, each call ended by
    a synchronize (a gloo rank's step syncs the stream at every
    collective, so events would not time the device alone)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def ring_inputs(torch):
    """Phase 7e's whole q, k, v and output gradient, bf16 on the card,
    the same in every process (a seeded card generator)."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(17)
    return flash_inputs(torch, gen, RING_B, RING_HQ, RING_HKV, RING_S, FD)


def ring_rank(rank: int, world: int, address: str, tmp: str) -> None:
    """One rank of phase 7e (a spawned process): its shard of the ring on
    cuda:0 over gloo, forward and backward through the flash kernels with
    the counters set to 0 just before and read just after, then the plain
    ring on the same shard; saves both results, the launches, the host
    times of a ring forward and backward, and its peak memory."""
    import torch
    from skypilot_tpu_torch.ops import attention as att
    from skypilot_tpu_torch.ops import ring_attention as ring
    from skypilot_tpu_torch.parallel import mesh
    group = mesh.axes_mesh(mesh.AxesShape(mesh.SP_AXES, (world,)), rank,
                           address, 'cuda:0', backend='gloo').group('sp')
    n = RING_S // world
    q, k, v, do = (t[:, :, rank * n:(rank + 1) * n].contiguous()
                   for t in ring_inputs(torch))
    torch.cuda.reset_peak_memory_stats()

    def run(fn, dtype):
        leaves = [t.to(dtype, copy=True).requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, group)
        return [out.detach(), *torch.autograd.grad(out, leaves,
                                                   do.to(dtype))]

    att.reset_launches()
    got = run(ring.ring_attention, torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(att.launches)
    # The plain ring on the same values in fp32: in bf16 its gradients
    # would round at every hop of the ring and every add.
    plain = run(ring.ring_attention_reference, torch.float32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd_s = gpu_seconds(torch, lambda: ring.ring_attention(*leaves, group),
                        5)
    out = ring.ring_attention(*leaves, group)
    bwd_s = gpu_seconds(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 5)
    torch.save({'got': [t.cpu() for t in got],
                'plain': [t.cpu() for t in plain], 'launches': launches,
                'fwd_ms': fwd_s * 1e3, 'bwd_ms': bwd_s * 1e3,
                'peak_memory_gb': peak}, os.path.join(tmp, f'ring{rank}.pt'))
    mesh.destroy(group)


def ring_on_one_card(torch, att, card: str):
    """Phase 7e: ring attention at Llama-3-8B's heads (32 query, 8 KV
    heads of 128, bf16, b 1) over 8,192 rows at sp 2, two gloo ranks on
    the card, forward and backward, against one rank's flash attention
    over the whole rows (out, dq, dk, dv) within RING_RTOL +
    RING_ATOL_FRAC of the largest magnitude, and the plain ring on the
    same values in fp32 within RING_PLAIN_REL by relative norm; each
    rank must have launched each flash kernel once a block the causal
    mask does not hide (rank r: r + 1). Also: a shard that the kernels
    refuse raises. Returns the launches summed over the ranks."""
    from skypilot_tpu_torch.ops import ring_attention as ring
    t0 = time.perf_counter()
    q, k, v, do = ring_inputs(torch)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves)
    want = [out.detach(), *torch.autograd.grad(out, leaves, do,
                                               retain_graph=True)]
    one_fwd = gpu_seconds(torch, lambda: att.flash_attention(*leaves), 5)
    one_bwd = gpu_seconds(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 5)
    del out, leaves
    refused = []
    for bad in ((q[:, :, :100], k[:, :, :100], v[:, :, :100]),
                (q[..., :96], k[..., :96], v[..., :96])):
        try:
            ring.ring_attention(*(t.contiguous() for t in bad), None)
        except ValueError:
            refused.append(True)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ring_') as tmp:
        spawn_ranks(ring_rank, RING_SP, (tmp,), 600, 'phase 7e')
        ranks = [torch.load(os.path.join(tmp, f'ring{r}.pt'))
                 for r in range(RING_SP)]
    names = ('out', 'dq', 'dk', 'dv')
    errs, checks = {}, []
    for i, name in enumerate(names):
        got = torch.cat([r['got'][i] for r in ranks], dim=2).cuda()
        errs[name], ok = compare(torch, got, want[i], RING_RTOL,
                                 RING_ATOL_FRAC)
        if not ok:
            checks.append(f'{name} vs one-rank flash: {errs[name]}')
    plain_errs = {}
    for r, res in enumerate(ranks):
        for i, name in enumerate(names):
            got, plain = res['got'][i].cuda().float(), res['plain'][i].cuda()
            e = ((got - plain).norm() / plain.norm()).item()
            plain_errs[name] = max(plain_errs.get(name, 0.0), e)
            if not e <= RING_PLAIN_REL:
                checks.append(f'rank {r} {name} vs the plain ring: {e} by '
                              f'relative norm')
        blocks = [res['launches'][k] for k in FLASH_KERNELS]
        if blocks != [r + 1] * 3:
            checks.append(f'rank {r} launched {res["launches"]}, want '
                          f'{r + 1} of each flash kernel')
    if refused != [True, True]:
        checks.append('a shard the kernels refuse did not raise')
    launches = {k: sum(r['launches'][k] for r in ranks)
                for k in ranks[0]['launches']}
    summary = {
        'card': card, 'shape': {'b': RING_B, 'hq': RING_HQ,
                                'hkv': RING_HKV, 's': RING_S, 'd': FD,
                                'sp': RING_SP, 'dtype': 'bfloat16'},
        'max_abs_err_vs_one_rank_flash': errs,
        'rtol': RING_RTOL, 'atol_frac': RING_ATOL_FRAC,
        'rel_norm_err_vs_plain_ring_fp32': plain_errs,
        'plain_rel_norm_atol': RING_PLAIN_REL,
        'launches_per_rank': [r['launches'] for r in ranks],
        'ring_fwd_ms_per_rank': [r['fwd_ms'] for r in ranks],
        'ring_bwd_ms_per_rank': [r['bwd_ms'] for r in ranks],
        'one_rank_flash_fwd_ms': one_fwd * 1e3,
        'one_rank_flash_bwd_ms': one_bwd * 1e3,
        'peak_memory_gb_per_rank': [r['peak_memory_gb'] for r in ranks],
        'wall_s': time.perf_counter() - t0}
    print('phase 7e (ring attention, sp 2 as 2 gloo ranks on one card, '
          f'{card}): ' + json.dumps(summary), flush=True)
    print(f'  ring forward {max(summary["ring_fwd_ms_per_rank"]):.2f} ms, '
          f'backward {max(summary["ring_bwd_ms_per_rank"]):.2f} ms (host '
          f'clock, gloo on one card, not a speed number); one rank\'s flash '
          f'over {RING_S} rows: forward {one_fwd * 1e3:.2f} ms, backward '
          f'{one_bwd * 1e3:.2f} ms', flush=True)
    if checks:
        fail('phase 7e: ' + '; '.join(checks))
    return launches


def grad_rel_errs(torch, got: dict, want: dict) -> dict:
    """{leaf: |got - want| / |want|} by norm, over the leaves of ``got``
    (``{path: leaf}``, as ``sharding.tree_leaves`` gives them)."""
    return {k: ((g.float().cuda() - want[k].float()).norm()
                / want[k].float().norm()).item() for k, g in got.items()}


def pp_batch(torch, vocab: int):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(23)
    tokens = torch.randint(0, vocab, (PP_MICROBATCHES, PP_SEQ + 1),
                           generator=gen, device='cuda')
    return tokens[:, :-1], tokens[:, 1:]


def pp_params(torch, llama, cfg):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(29)
    return llama.init_params(cfg, gen, 'cuda')


def pp_rank(rank: int, world: int, address: str, tmp: str) -> None:
    """One rank of phase 7f (a spawned process): its stage of the GPipe
    pipeline on cuda:0 over gloo, one loss and backward with the counters
    set to 0 just before and read just after; saves the loss, its
    gradients (finished by ``pipeline.reduce_grads``), the launches, the
    host time of a step and its peak memory."""
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention as att
    from skypilot_tpu_torch.parallel import mesh
    from skypilot_tpu_torch.parallel import pipeline
    from skypilot_tpu_torch.parallel import sharding
    m = mesh.axes_mesh(mesh.AxesShape(mesh.PP_AXES, (1, world)), rank,
                       address, 'cuda:0', backend='gloo')
    cfg = llama.LlamaConfig.bench_1b()
    params = pipeline.stage_params(pp_params(torch, llama, cfg),
                                   m.coord('pp'), world)
    torch.cuda.empty_cache()
    flat = sharding.tree_leaves(params)
    for t in flat.values():
        t.requires_grad_(True)
    tokens, targets = pp_batch(torch, cfg.vocab_size)
    fn = pipeline.llama_pp_loss_fn(cfg, m.group('pp'), PP_MICROBATCHES)
    torch.cuda.reset_peak_memory_stats()

    def step():
        loss = fn(params, tokens, targets)
        grads = torch.autograd.grad(loss, list(flat.values()))
        return loss, grads

    att.reset_launches()
    loss, grads = step()
    torch.cuda.synchronize()
    launches = dict(att.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    by_path = dict(zip(flat, grads))
    finished = sharding.tree_leaves(pipeline.reduce_grads(
        sharding.map_tree(lambda path, _: by_path[path], params),
        m.group('pp')))
    del grads, by_path
    step_s = gpu_seconds(torch, step, 2)
    torch.save({'loss': loss.item(),
                'grads': {k: g.cpu() for k, g in finished.items()},
                'launches': launches, 'step_ms': step_s * 1e3,
                'peak_memory_gb': peak},
               os.path.join(tmp, f'pp{rank}.pt'))
    mesh.destroy_mesh(m)


def pp_on_one_card(torch, card: str):
    """Phase 7f: the GPipe pipeline over bench_1b at its full 24 layers,
    pp 2 as two gloo ranks on the card, PP_MICROBATCHES microbatches of 1
    x PP_SEQ, against one rank's plain-loss ``llama.loss_fn`` on the same
    bf16 params and batch: every rank's loss within MESH_LOSS_ATOL, each
    of its gradient leaves (its stage's layers, the embed, final norm and
    head) within PP_GRAD_REL by relative norm; the flash forward, dQ and
    dK/dV launched on both ranks. Returns the launches summed over the
    ranks."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.bench_1b()
    params = pp_params(torch, llama, cfg)
    flat = sharding.tree_leaves(params)
    for t in flat.values():
        t.requires_grad_(True)
    tokens, targets = pp_batch(torch, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()

    def step():
        loss = llama.loss_fn(cfg, params, tokens, targets)
        return loss, torch.autograd.grad(loss, list(flat.values()))

    loss, grads = step()
    want = dict(zip(flat, grads))
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    one_s = gpu_seconds(torch, step, 2)
    del params, flat, grads
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pp_') as tmp:
        spawn_ranks(pp_rank, PP_STAGES, (tmp,), 900, 'phase 7f')
        ranks = [torch.load(os.path.join(tmp, f'pp{r}.pt'))
                 for r in range(PP_STAGES)]
    n = cfg.n_layers // PP_STAGES
    checks, rel = [], []
    for r, res in enumerate(ranks):
        if abs(res['loss'] - loss.item()) > MESH_LOSS_ATOL:
            checks.append(f'rank {r} loss {res["loss"]} vs one rank '
                          f'{loss.item()}')
        slices = {k: (w[r * n:(r + 1) * n] if k[0] == 'layers' else w)
                  for k, w in want.items()}
        rel.append(grad_rel_errs(torch, res['grads'], slices))
        worst = max(rel[-1].values())
        if worst > PP_GRAD_REL:
            checks.append(f'rank {r} gradients part by {worst} '
                          f'(rel norm): {rel[-1]}')
        missing = [k for k in FLASH_KERNELS if res['launches'][k] <= 0]
        if missing:
            checks.append(f'rank {r}: {missing} not launched')
    launches = {k: sum(r['launches'][k] for r in ranks)
                for k in ranks[0]['launches']}
    summary = {
        'card': card, 'model': 'bench_1b', 'n_layers': cfg.n_layers,
        'pp': PP_STAGES, 'microbatches': PP_MICROBATCHES,
        'microbatch': f'1 x {PP_SEQ}', 'one_rank_loss': loss.item(),
        'pp_losses': [r['loss'] for r in ranks],
        'loss_atol': MESH_LOSS_ATOL,
        'grad_rel_norm_err_max_per_rank': [max(e.values()) for e in rel],
        'grad_rel_norm_atol': PP_GRAD_REL,
        'launches_per_rank': [r['launches'] for r in ranks],
        'pp_step_ms_per_rank': [r['step_ms'] for r in ranks],
        'one_rank_step_ms': one_s * 1e3,
        'peak_memory_gb_per_rank': [r['peak_memory_gb'] for r in ranks],
        'one_rank_peak_memory_gb': one_peak,
        'wall_s': time.perf_counter() - t0}
    print(f'phase 7f (GPipe pipeline, pp 2 as 2 gloo ranks on one card, '
          f'{card}): ' + json.dumps(summary), flush=True)
    print(f'  pp 2 step (loss and gradients) '
          f'{max(summary["pp_step_ms_per_rank"]):.1f} ms (host clock, gloo '
          f'on one card, not a speed number); one rank {one_s * 1e3:.1f} ms',
          flush=True)
    if checks:
        fail('phase 7f: ' + '; '.join(checks))
    return launches


def moe_config(moe):
    return moe.MoEConfig.mixtral_8x7b(n_layers=MOE_LAYERS)


def moe_inputs(torch, moe, cfg):
    """Phase 7g's whole bf16 params and batch, the same in every process
    (seeded card generators)."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(31)
    params = moe.init_params(cfg, gen, 'cuda')
    tokens = torch.randint(0, cfg.vocab_size, (MOE_B, MOE_S + 1),
                           generator=gen, device='cuda')
    return params, tokens[:, :-1], tokens[:, 1:]


def moe_steps(torch, moe, cfg, params, tokens, targets, shard=None,
              mesh=None):
    """The loss, aux terms and gradients (finished on a mesh rank) at
    ``params``, then MOE_SGD_STEPS plain SGD steps in place at MOE_SGD_LR;
    returns (first loss and aux, first gradients, every loss)."""
    from skypilot_tpu_torch.parallel import sharding
    flat = sharding.tree_leaves(params)
    for t in flat.values():
        t.requires_grad_(True)

    def step():
        total, aux = moe.loss_fn(cfg, params, tokens, targets, shard=shard)
        grads = dict(zip(flat, torch.autograd.grad(total,
                                                   list(flat.values()))))
        if mesh is not None:
            grads = sharding.tree_leaves(moe.reduce_grads(
                sharding.map_tree(lambda path, _: grads[path], params),
                mesh))
        return total, aux, grads

    total, aux, grads = step()
    first = {'loss': total.item(), **{k: v.item() for k, v in aux.items()}}
    first_grads = grads
    losses = [total.item()]
    for _ in range(MOE_SGD_STEPS):
        with torch.no_grad():
            for k, t in flat.items():
                t -= MOE_SGD_LR * grads[k]
        total, _, grads = step()
        losses.append(total.item())
    return first, first_grads, losses, step


def moe_rank(rank: int, world: int, address: str, tmp: str) -> None:
    """One rank of phase 7g (a spawned process): its experts (ep
    ``world``) and rows of the MoE on cuda:0 over gloo, the loss and
    gradients with the counters set to 0 just before and read just after,
    then the SGD steps; saves the losses, the first gradients, the
    launches, the host time of a step and its peak memory."""
    import torch
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.ops import attention as att
    from skypilot_tpu_torch.parallel import mesh
    m = mesh.axes_mesh(mesh.AxesShape(mesh.EP_AXES, (1, 1, world)), rank,
                       address, 'cuda:0', backend='gloo',
                       combined=(('fsdp', 'ep'),))
    cfg = moe_config(moe)
    shard = moe.MeshOps(m)
    whole, tokens, targets = moe_inputs(torch, moe, cfg)
    params = moe.shard_params(whole, m)
    del whole
    torch.cuda.empty_cache()
    rows = MOE_B // shard.data.world
    r0 = shard.data.rank * rows
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()
    first, grads, losses, step = moe_steps(
        torch, moe, cfg, params, tokens[r0:r0 + rows],
        targets[r0:r0 + rows], shard, m)
    torch.cuda.synchronize()
    launches = dict(att.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # One timed step: gloo stages the expert buffers through the host
    # (3.8-4.9 s a step on an NVIDIA H100 80GB HBM3 at 700 W), and the
    # time is not a speed number.
    step_s = gpu_seconds(torch, step, 1)
    torch.save({'first': first, 'losses': losses,
                'grads': {k: g.cpu() for k, g in grads.items()},
                'launches': launches, 'step_ms': step_s * 1e3,
                'peak_memory_gb': peak},
               os.path.join(tmp, f'moe{rank}.pt'))
    mesh.destroy_mesh(m)


def moe_on_one_card(torch, card: str):
    """Phase 7g: the MoE at Mixtral-8x7B's width (``reduced`` to
    MOE_LAYERS layers: see MOE_REDUCED), b MOE_B x s MOE_S, ep 2 as two
    gloo ranks on the card against ep 1 in this process on the same bf16
    params and batch: the loss and aux terms within MESH_LOSS_ATOL, every
    gradient leaf of each rank (its experts, the rest whole) within
    MOE_GRAD_REL by relative norm, the flash kernels launched on both
    ranks; MOE_SGD_STEPS SGD steps lower the loss on both sides (the
    reference's ``test_moe_trains``). Returns the launches summed over
    the ranks."""
    from skypilot_tpu_torch.models import moe
    t0 = time.perf_counter()
    cfg = moe_config(moe)
    params, tokens, targets = moe_inputs(torch, moe, cfg)
    torch.cuda.reset_peak_memory_stats()
    first, want, losses, step = moe_steps(torch, moe, cfg, params, tokens,
                                          targets)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    one_s = gpu_seconds(torch, step, 2)
    del params, step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_moe_') as tmp:
        spawn_ranks(moe_rank, MOE_EP, (tmp,), 900, 'phase 7g')
        ranks = [torch.load(os.path.join(tmp, f'moe{r}.pt'))
                 for r in range(MOE_EP)]
    checks, rel = [], []
    if not losses[-1] < losses[0]:
        checks.append(f'ep 1: SGD did not lower the loss: {losses}')
    for r, res in enumerate(ranks):
        for k, v in first.items():
            if abs(res['first'][k] - v) > MESH_LOSS_ATOL:
                checks.append(f'rank {r} {k} {res["first"][k]} vs ep 1 {v}')
        if not res['losses'][-1] < res['losses'][0]:
            checks.append(f'rank {r}: SGD did not lower the loss: '
                          f'{res["losses"]}')
        n = cfg.n_experts // MOE_EP
        slices = {k: (w[:, r * n:(r + 1) * n]
                      if moe.leaf_spec(k).ep is not None
                      else w) for k, w in want.items()}
        rel.append(grad_rel_errs(torch, res['grads'], slices))
        worst = max(rel[-1].values())
        if worst > MOE_GRAD_REL:
            checks.append(f'rank {r} gradients part by {worst} '
                          f'(rel norm): {rel[-1]}')
        missing = [k for k in FLASH_KERNELS if res['launches'][k] <= 0]
        if missing:
            checks.append(f'rank {r}: {missing} not launched')
    launches = {k: sum(r['launches'][k] for r in ranks)
                for k in ranks[0]['launches']}
    summary = {
        'card': card, 'model': 'mixtral_8x7b width', 'reduced': MOE_REDUCED,
        'n_layers': cfg.n_layers, 'batch': f'{MOE_B} x {MOE_S}',
        'ep': MOE_EP, 'ep1': first, 'ep2_per_rank': [r['first']
                                                     for r in ranks],
        'loss_atol': MESH_LOSS_ATOL,
        'grad_rel_norm_err_max_per_rank': [max(e.values()) for e in rel],
        'grad_rel_norm_atol': MOE_GRAD_REL, 'sgd_lr': MOE_SGD_LR,
        'sgd_losses_ep1': losses,
        'sgd_losses_ep2_per_rank': [r['losses'] for r in ranks],
        'launches_per_rank': [r['launches'] for r in ranks],
        'ep2_step_ms_per_rank': [r['step_ms'] for r in ranks],
        'ep1_step_ms': one_s * 1e3,
        'peak_memory_gb_per_rank': [r['peak_memory_gb'] for r in ranks],
        'ep1_peak_memory_gb': one_peak,
        'wall_s': time.perf_counter() - t0}
    print(f'phase 7g (MoE, ep 2 as 2 gloo ranks on one card, {card}): '
          + json.dumps(summary), flush=True)
    print(f'  ep 2 step (loss and gradients) '
          f'{max(summary["ep2_step_ms_per_rank"]):.1f} ms (host clock, gloo '
          f'on one card, not a speed number); ep 1 {one_s * 1e3:.1f} ms; '
          f'peak memory ep 1 {one_peak:.2f} GB, ep 2 ranks '
          f'{summary["peak_memory_gb_per_rank"]} GB', flush=True)
    if checks:
        fail('phase 7g: ' + '; '.join(checks))
    return launches


# ---------------------------------------------------------------------------
# Phase 7: training end to end
# ---------------------------------------------------------------------------
def run_logged(cmd, log_name: str, timeout: float):
    """Run ``cmd`` from the repo root; its output goes to
    chiprun_out/<log_name>. Returns (stdout, stderr); fails on a non-zero
    exit."""
    OUT_DIR.mkdir(exist_ok=True)
    print('running: ' + ' '.join(cmd[1:]), flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    (OUT_DIR / log_name).write_text(
        f'$ {" ".join(cmd)}\n--- stdout\n{proc.stdout}\n--- stderr\n'
        f'{proc.stderr}')
    print(f'  exit {proc.returncode} after {time.time() - t0:.1f} s',
          flush=True)
    if proc.returncode != 0:
        fail(f'{" ".join(cmd[1:])} exited {proc.returncode}:\n'
             f'{proc.stderr[-3000:]}')
    return proc.stdout, proc.stderr


def train_leaves(config) -> int:
    """The leaves of ``config``'s params: the optimizer's kernel launches
    once a leaf a step."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    return len(trainer._leaves(llama.init_params(config, None, 'meta')))


def run_bench(ce_flavor: str, card: str, remat: str = 'full'):
    """bench_1b's train step under the flags; fails unless the loss is
    finite and the AdamW update launched once a leaf a timed step."""
    from skypilot_tpu_torch.models import llama
    flags = ['--attn', 'flash', '--ce', ce_flavor, '--remat-policy', remat]
    suffix = '' if remat == 'full' else f'_{remat}'
    out, _ = run_logged(
        [sys.executable, '-m', 'skypilot_tpu_torch.bench', *flags],
        f'chip_smoke_bench_{ce_flavor}{suffix}.log', 900)
    result = json.loads(out.strip().splitlines()[-1])
    print(f'bench_1b train step ({" ".join(flags)}, {card}): '
          + json.dumps(result), flush=True)
    if not math.isfinite(result['loss']):
        fail(f'bench loss is not finite: {result["loss"]}')
    leaves = train_leaves(llama.LlamaConfig.bench_1b())
    if result['launches_per_step'].get('adamw_update') != leaves:
        fail(f'bench {" ".join(flags)}: adamw_update launched '
             f'{result["launches_per_step"].get("adamw_update")} times a '
             f'step, want one a leaf ({leaves})')
    return result


def train_and_resume(card: str, after=None):
    """llama-350m (head_dim 64, group 2: the flash kernels' other
    variant) for 4 steps with a checkpoint every 2, then to step 6 from
    the same directory, which must resume at step 4; then ``after`` (if
    given) with the directory. The checkpoints (about 2 GB each) go to a
    temporary directory that is removed."""
    pat = re.compile(r'step (\d+)/(\d+) loss=(\S+) tokens/s=(\d+)')
    runs = []
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ckpt_') as ckpt:
        for steps in (4, 6):
            _, err = run_logged(
                [sys.executable, '-m', 'skypilot_tpu_torch.train.run',
                 '--model', 'llama-350m', '--steps', str(steps), '--batch',
                 '4', '--seq', '2048', '--checkpoint-dir', ckpt,
                 '--checkpoint-every', '2', '--log-every', '1'],
                f'chip_smoke_train_{steps}.log', 900)
            logged = [(int(m.group(1)), float(m.group(3)), int(m.group(4)))
                      for m in pat.finditer(err)]
            resumed = re.search(r'resumed from checkpoint at step (\d+)',
                                err)
            runs.append({'steps': steps,
                         'resumed_at': int(resumed.group(1)) if resumed
                         else None,
                         'logged': logged,
                         'checkpoints': sorted(os.listdir(ckpt))})
        if after is not None:
            after(ckpt)
    print(f'llama-350m train and resume ({card}): ' + json.dumps(runs),
          flush=True)
    first, second = runs
    if [s for s, _, _ in first['logged']] != [1, 2, 3, 4] \
            or first['resumed_at'] is not None:
        fail(f'the first llama-350m run did not log steps 1-4 fresh: {first}')
    if second['resumed_at'] != 4 \
            or [s for s, _, _ in second['logged']] != [5, 6]:
        fail(f'the second llama-350m run did not resume at step 4: {second}')
    if not all(math.isfinite(loss) for r in runs
               for _, loss, _ in r['logged']):
        fail('llama-350m logged a non-finite loss')
    return runs


def serve_checkpoint_int8(torch, quant, card: str, ckpt: str):
    """Phase 7b: ``server --model 350m --checkpoint <ckpt> --quantize``
    (phase 7's train.run directory: a train state at step 6) answers 8
    greedy requests; their tokens must equal an in-process engine's on
    ``restore_to_host`` + ``quantize_params(..., 'cuda')`` of the same
    directory, and qdot_int8 must have launched in the server."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    cfg = llama.LlamaConfig.bench_350m()
    rnd = random.Random(7)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in (17, 64, 100, 300, 5, 129, 256, 700)]
    new = 32
    with served(['--model', '350m', '--paged', '--checkpoint', ckpt,
                 '--quantize', '--slots', '8', '--max-seq-len', str(MAX_SEQ)],
                'chip_smoke_server_350m_ckpt.log') as base:
        served_out, _ = burst(base, prompts, new, cfg.vocab_size)
        _, raw = http_json(base + '/metrics')
        m = json.loads(raw)
    restored = ckpt_lib.CheckpointManager(ckpt).restore_to_host()
    qparams = quant.quantize_params(restored.params, 'cuda')
    del restored
    eng = engine_lib.InferenceEngine(
        cfg, qparams, engine_lib.EngineConfig(
            n_slots=8, max_seq_len=MAX_SEQ, paged=True, page_size=PAGE,
            quantize=True),
        seed=0, device='cuda')
    local = [r.output_tokens for r in eng.generate(prompts, new)]
    del eng, qparams
    torch.cuda.empty_cache()
    parted = [i for i, (r, want) in enumerate(zip(served_out, local))
              if r[0] != want]
    summary = {'card': card, 'prompt_tokens': [len(p) for p in prompts],
               'max_new_tokens': new, 'parted': parted,
               'param_bytes': m['param_bytes'],
               'qdot_int8_launches': m['kernel_launches']['qdot_int8'],
               'step_programs': m['step_programs']}
    print('phase 7b (llama-350m checkpoint served with --quantize, '
          + card + '): ' + json.dumps(summary), flush=True)
    if parted:
        fail(f'phase 7b: requests {parted} gave other tokens than the '
             f'in-process engine on the same checkpoint')
    if m['kernel_launches']['qdot_int8'] <= 0:
        fail('phase 7b: qdot_int8 never launched in the checkpoint server')
    return summary


# ---------------------------------------------------------------------------
# --profile: where a training step's time goes
# ---------------------------------------------------------------------------
def _train_kernel_kind(name: str) -> str:
    low = name.lower()
    for key in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv', 'ce_fwd'):
        if key in low:
            return key
    return _kernel_kind(name)


def profile_train(torch, card: str) -> None:
    """bench_1b (--attn flash --ce fused) in process: host-clock step
    time over 3 steps, then ``torch.profiler`` over one more: device
    time by kernel kind and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = llama.LlamaConfig.bench_1b(attention_impl='flash', fused_loss=True)
    opt = trainer.make_optimizer(total_steps=1000, mu_dtype='bfloat16')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    state = trainer.init_train_state(cfg, gen, opt, 'cuda')
    step = trainer.make_train_step(cfg, opt)
    batch = trainer.synthetic_batch(cfg, 6, FS, gen, 'cuda')
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kinds, kernels = {}, {}
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kind = _train_kernel_kind(e.key)
            kinds[kind] = kinds.get(kind, 0) + us / 1e3
            kernels[e.key] = (us / 1e3, e.count)
    busy = sum(kinds.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    print(f'train step profile (bench_1b, b 6, s {FS}, flash + fused CE, '
          f'{card}): ' + json.dumps({
              'step_ms': step_ms, 'profiled_step_ms': window_ms,
              'device_busy_ms': busy, 'device_busy_share': busy / window_ms,
              'kernel_launches': sum(c for _, c in kernels.values()),
              'device_ms_by_kind': kinds,
              'top_kernels': [{'name': k[:100], 'ms': ms, 'launches': c}
                              for k, (ms, c) in top]}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernels-only', action='store_true',
                        help='stop after holding the kernels against '
                             'their plain versions')
    parser.add_argument('--only-parallel', action='store_true',
                        help='after the build, run phases 7e-7g (ring '
                             'attention, the pipeline, the MoE) alone')
    parser.add_argument('--profile', action='store_true',
                        help='at the end, profile decode steps of an '
                             'in-process engine and a bench_1b train step')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import attention as att
    from skypilot_tpu_torch.ops import cross_entropy as ce
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops import quant
    # The plain versions' fp32 products stay fp32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 1: the card.
    card = card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    # Phase 2: build from the checkout's sources.
    t0 = time.perf_counter()
    secs = _build.build()
    print(f'built {", ".join(f"{k} {v:.1f}s" for k, v in secs.items())} '
          f'({time.perf_counter() - t0:.1f} s wall)', flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line \
                    or 'Compiling entry' in line or 'arning' in line:
                print(f'  {name}: {line.strip()}', flush=True)
    check_sass(_build)
    if args.only_parallel:
        ring_on_one_card(torch, att, card)
        pp_on_one_card(torch, card)
        moe_on_one_card(torch, card)
        print('only-parallel: phases 7e-7g passed', flush=True)
        return 0
    # A CUDA graph keeps the split kernels' workspace pointers: size the
    # workspaces for the widest launch any engine or check in this
    # process makes (8 slots of 32 pages; the dense cases' 16 slots of 32
    # pages and 3 of 128; a 256-token chunk over the long tier's 128-page
    # row) before anything is captured.
    pa.reserve_split_scratch('cuda', 8, HKV, HD, MAX_SEQ // PAGE)
    for rows, lengths in DENSE_DECODE_CASES + DENSE_VERIFY_CASES:
        pa.reserve_split_scratch('cuda', len(lengths), HKV, HD, rows // PAGE)
    pa.reserve_prefill_scratch('cuda', HKV, PREFILL_C * GROUP, HD,
                               LONG_SEQ // PAGE)

    # Phase 3: kernels vs their plain versions.
    checked = check_kernels(torch, pa)
    dense_checked = check_dense_prefill(torch, pa)
    check_dense_attention(torch, pa)
    tp_checked = check_tp_attention(torch, pa)
    checked.update(check_spec_int8_kernels(torch, pa))
    checked.update(check_qdot_kernel(torch, quant))
    checked.update(check_training_kernels(torch, att, ce))
    tp_train_checked = check_tp_training_kernels(torch, att)
    checked.update(check_adamw_kernel(torch))
    print('paged_prefill: the device-scalar entry is bitwise the '
          'host-scalar entry at ' + json.dumps(DEVICE_SCALAR_CHECKS)
          + ' cases (every prefill case, split edge and page type above)',
          flush=True)
    if not all(DEVICE_SCALAR_CHECKS.values()):
        fail(f'the device-scalar prefill entry was not checked on every '
             f'page type: {DEVICE_SCALAR_CHECKS}')
    if args.kernels_only:
        print('kernels-only: every kernel agrees with its plain version',
              flush=True)
        return 0

    # Phase 4: timing.
    timed = time_kernels(torch, pa, checked)
    timed.update(time_spec_int8_kernels(torch, pa, checked))
    timed.update(time_qdot_kernel(torch, quant))
    timed.update(time_training_kernels(torch, att, ce, checked))
    timed.update(time_adamw_kernel(torch))
    # The dense cache's chunks: C 16 at offset 1792 (the 16-token bucket),
    # and a 256-token chunk at offset 7936 over a 128-page row.
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    dense_timed = {name: time_prefill(torch, pa, case, {}, off, tl, flush)
                   for name, (_, case, off, tl) in dense_checked.items()}
    print_timed(dense_timed)
    time_tp_attention(torch, pa, tp_checked)
    time_tp_training_kernels(torch, att, tp_train_checked)
    del flush, dense_checked, tp_checked, tp_train_checked
    for key in checked:              # keep the errors, free the inputs
        checked[key] = (checked[key][0],)
    torch.cuda.empty_cache()

    # Phase 5: the serving path, end to end through the servers.
    launches, bf16 = run_server(
        card, ['--spec-k', str(VERIFY_R - 1)], 'chip_smoke_server.log',
        ('paged_decode_attention', 'paged_prefill_attention',
         'paged_verify_attention'), '8 slots, bf16 pages, spec_k 4')
    int8_launches, int8 = run_server(
        card, ['--kv-dtype', 'int8', '--spec-k', str(VERIFY_R - 1)],
        'chip_smoke_server_int8.log',
        ('paged_decode_attention_int8', 'paged_prefill_attention_int8',
         'paged_verify_attention_int8'), '8 slots, int8 pages, spec_k 4')
    launches = {k: launches[k] + int8_launches[k] for k in launches}
    print('bf16 vs int8 pages (' + card + '): ' + json.dumps({
        key: [bf16[key], int8[key]]
        for key in ('ttft_cold_p50_s', 'ttft_warm_p50_s', 'kv_page_bytes')}
        | {'itl_p50_ms': [bf16['decode_burst']['itl_p50_ms'],
                          int8['decode_burst']['itl_p50_ms']],
           'tokens_per_sec': [bf16['decode_burst']['tokens_per_sec'],
                              int8['decode_burst']['tokens_per_sec']],
           'kv_page_bytes_ratio': bf16['kv_page_bytes']
           / int8['kv_page_bytes']}), flush=True)

    # Phase 5b: speculation in process at full width and depth.
    serving_in_process(torch, pa, card)
    # Phase 5d: fused mixed steps and the sentinel.
    fused_in_process(torch, pa, card)
    # Phase 5e: the prefix cache and KV prefix transfer; then the chunked
    # sweep at one level.
    prefix_launches = prefix_in_process(torch, pa, card)
    chunked_sweep(torch, card)
    # Phase 5f: int8 weights in process, then the int8-weight server.
    int8_weights_in_process(torch, pa, quant, card)
    w8_launches, w8 = run_server(
        card, ['--quantize', '--spec-k', str(VERIFY_R - 1)],
        'chip_smoke_server_int8_weights.log',
        ('qdot_int8', 'paged_decode_attention', 'paged_prefill_attention',
         'paged_verify_attention'),
        '8 slots, int8 weights, bf16 pages, spec_k 4')
    launches['qdot_int8'] = w8_launches['qdot_int8']
    print('bf16 vs int8 weights (' + card + '): ' + json.dumps({
        key: [bf16[key], w8[key]]
        for key in ('ttft_cold_p50_s', 'ttft_warm_p50_s')}
        | {'itl_p50_ms': [bf16['decode_burst']['itl_p50_ms'],
                          w8['decode_burst']['itl_p50_ms']],
           'tokens_per_sec': [bf16['decode_burst']['tokens_per_sec'],
                              w8['decode_burst']['tokens_per_sec']]}),
          flush=True)

    # Phase 5g: the dense cache in process, then the dense two-tier
    # replica (the reference server's default flags).
    _, dense_launches = dense_in_process(torch, pa, card)
    pool_launches = dense_replica(torch, quant, card)
    dense_launches = {k: dense_launches.get(k, 0) + pool_launches.get(k, 0)
                      for k in set(dense_launches) | set(pool_launches)}
    # Phase 5h: tensor parallelism, two gloo ranks on the one card.
    tp_launches = tp_in_process(torch, quant, card)
    # Phase 5i: the replica booted twice on one kernel directory, the
    # serving sweeps against it, and the profile smoke.
    sweep_launches = replica_sweeps(torch, card)

    # Phase 6: the training slice against its plain path; 6b: the remat
    # policies against full.
    check_slice(torch, att, ce)
    torch.cuda.empty_cache()
    check_remat(torch, att, ce)
    torch.cuda.empty_cache()

    # Phase 7: the training path, end to end.
    bench = run_bench('fused', card)
    per_step = bench['launches_per_step']
    if any(bench['launches'][k] <= 0 for k in TRAINING_KERNELS):
        fail(f'a training kernel was not launched on the main path: '
             f'{bench["launches"]}')
    launches.update(bench['launches'])
    print(f'bench_1b launches per step: {json.dumps(per_step)}', flush=True)
    run_bench('dense', card)
    # The selective remat policies: save_attn keeps the flash forward's
    # outputs (one launch a layer a step), dots the 2-D products'.
    remat = {'full': bench}
    for policy in ('save_attn', 'dots'):
        remat[policy] = run_bench('fused', card, policy)
        got = remat[policy]['launches_per_step']['flash_attention_fwd']
        want = 24 if policy == 'save_attn' else 48
        if got != want:
            fail(f'bench --remat-policy {policy}: {got} flash forward '
                 f'launches a step, want {want}')
    print('bench_1b by remat policy (' + card + '): ' + json.dumps({
        policy: {k: r[k] for k in ('value', 'mfu', 'step_ms',
                                   'peak_memory_gb')}
        | {'flash_fwd_per_step':
           r['launches_per_step']['flash_attention_fwd']}
        for policy, r in remat.items()}), flush=True)
    # Phase 7b: the trained checkpoint served with --quantize.
    train_and_resume(card, after=lambda ckpt: serve_checkpoint_int8(
        torch, quant, card, ckpt))
    # Phase 7c: sharded training, 4 gloo ranks on the card; 7d: ResNet
    # DDP, 2 gloo ranks on the card.
    mesh_launches = train_mesh_on_one_card(torch, card)
    vision_ddp_on_one_card(torch, card)
    # Phases 7e-7g: ring attention (sp 2), the GPipe pipeline (pp 2) and
    # the MoE (ep 2), each as 2 gloo ranks on the card.
    ring_launches = ring_on_one_card(torch, att, card)
    pp_launches = pp_on_one_card(torch, card)
    moe_launches = moe_on_one_card(torch, card)
    if args.profile:
        for kv_dtype in ('bfloat16', 'int8'):
            for verify in (False, True):
                # The synchronous eager loop, then the default one.
                for graphs, depth in ((False, 0), (True, 1)):
                    profile_decode(torch, pa, card, kv_dtype, verify,
                                   graphs, depth)
        for graphs, depth in ((False, 0), (True, 1)):
            profile_decode(torch, pa, card, 'bfloat16', False, graphs,
                           depth, quantize=True)
        for graphs, depth in ((False, 0), (True, 1)):
            profile_decode(torch, pa, card, 'bfloat16', False, graphs,
                           depth, paged=False)
        # The two-tier replica's short tier (5g(b): 16 dense slots, int8
        # weights) beside 8 such slots, the default loop.
        for slots in (8, 16):
            profile_decode(torch, pa, card, 'bfloat16', False, True, 1,
                           quantize=True, paged=False, slots=slots)
        for mixed in (True, False):
            for graphs in (False, True):
                profile_chunks(torch, pa, card, mixed, graphs)
        profile_recorder(torch, card)
        profile_train(torch, card)

    rows = [
        ('paged_decode_attention', 'paged_decode', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:164'),
        ('paged_prefill_attention', 'paged_prefill', 'paged_prefill',
         'skypilot_tpu/ops/paged_attention.py:341'),
        ('paged_verify_attention', 'paged_verify', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:545'),
        ('paged_decode_attention_int8', 'paged_decode_int8', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:164'),
        ('paged_prefill_attention_int8', 'paged_prefill_int8',
         'paged_prefill', 'skypilot_tpu/ops/paged_attention.py:341'),
        ('paged_verify_attention_int8', 'paged_verify_int8', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:545'),
        ('flash_attention_fwd', 'flash_attention_fwd', 'flash_fwd',
         'skypilot_tpu/ops/attention.py:63'),
        ('flash_attention_bwd_dq', 'flash_attention_bwd_dq', 'flash_bwd',
         'skypilot_tpu/ops/attention.py:169'),
        ('flash_attention_bwd_dkv', 'flash_attention_bwd_dkv', 'flash_bwd',
         'skypilot_tpu/ops/attention.py:213'),
        ('fused_cross_entropy_fwd', 'fused_cross_entropy_fwd', 'ce_fwd',
         'skypilot_tpu/ops/cross_entropy.py:131'),
        ('qdot_int8', 'qdot_int8', 'qdot_int8',
         'skypilot_tpu/ops/quant.py:73'),
        ('adamw_update', 'adamw_update', 'adamw',
         'skypilot_tpu/train/trainer.py:43'),
    ]
    kernels = []
    for wrapper, key, source, where in rows:
        r = timed[key]
        kernels.append({
            'name': wrapper, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/ops/csrc/{source}.cu',
            'replaces': where, 'launches': launches[wrapper],
            # Phase 5e's cache-on runs, counted from 0 before each.
            'launches_prefix_cache': prefix_launches.get(wrapper, 0),
            # Phase 5g's dense runs (counted from 0 before the first) and
            # the dense replica's requests after its warm-up.
            'launches_dense': dense_launches.get(wrapper, 0),
            # Phase 5h's two ranks at tp 2, both variants, summed (each
            # rank's counters set to 0 just before it served).
            'launches_tp2': tp_launches.get(wrapper, 0),
            # Phase 5i's sweeps against the second boot (the server's
            # counters read just before and just after them).
            'launches_sweeps': sweep_launches.get(wrapper, 0),
            # Phase 7c's four ranks at fsdp 2 x tp 2, summed (each rank's
            # counters set to 0 just before it trained).
            'launches_train_mesh': mesh_launches.get(wrapper, 0),
            # Phases 7e, 7f and 7g: the two ranks of each, summed (each
            # rank's counters set to 0 just before its main path).
            'launches_ring': ring_launches.get(wrapper, 0),
            'launches_pipeline': pp_launches.get(wrapper, 0),
            'launches_moe': moe_launches.get(wrapper, 0),
            'max_abs_err': checked[key][0], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound'][0],
            'bound_by': r['bound'][1], 'library_ms': r['library_ms']})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
