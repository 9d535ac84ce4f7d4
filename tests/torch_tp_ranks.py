"""Rank programs of the port's multi-process tests
(``test_torch_tp.py``, ``test_torch_multihost.py``): each rank is a
process started by ``torch.multiprocessing`` with the ``spawn`` method,
which imports this module, so nothing here imports JAX. The ranks join a
``gloo`` group on the CPU at a free localhost port."""
from __future__ import annotations

import json
import pathlib
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.multiprocessing as mp

from skypilot_tpu_torch.infer import cache as cache_lib
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import model as model_lib
from skypilot_tpu_torch.infer import multihost
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh

CFG = llama.LlamaConfig.tiny()
# The reference's tp workload (tests/unit_tests/test_infer.py).
PROMPTS = [[5, 17, 101, 7], [9, 9, 3]]
NEW = 8
KW = dict(n_slots=2, max_seq_len=64, prefill_buckets=(8, 16, 32))


def start(fn, world: int, args: tuple) -> list:
    """Start ``fn(rank, world, address, *args)`` in ``world`` spawned
    processes at a free localhost port; returns them."""
    address = f'127.0.0.1:{mesh.free_port()}'
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=fn, args=(rank, world, address) + args)
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def spawn(fn, world: int, args: tuple, timeout: float = 120.0
          ) -> List[int]:
    """Run ``fn(rank, world, address, *args)`` in ``world`` spawned
    processes; returns their exit codes. A rank still alive after
    ``timeout`` seconds is killed, and its code is then not 0."""
    procs = start(fn, world, args)
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def save_params(tree, path) -> None:
    """A numpy param tree (``jax.tree.map(np.asarray, params)``) as an
    npz of '/'-joined keys."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat['/'.join(prefix)] = np.asarray(node)
    walk(tree, ())
    np.savez(path, **flat)


def load_params(path) -> llama.Params:
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split('/')
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return llama.params_from_jax(tree)


class OracleDrafter:
    """Proposes each known prompt's speculation-off continuation (the
    same drafts on every rank)."""

    def __init__(self, prompts, outputs):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                return out[len(context) - len(prompt):][:k]
        return []


def _lockstep(engine, group, prompts, new):
    """Serve ``prompts`` in lockstep: rank 0 submits from a side
    thread and stops the loop once all are done; every rank ticks.
    Returns rank 0's token lists (None elsewhere)."""
    drv = multihost.MultihostEngineDriver(engine, group)
    if group.rank != 0:
        drv.run()
        return None
    out = {}

    def work():
        reqs = [drv.submit(p, max_new_tokens=new) for p in prompts]
        while not all(r.done for r in reqs):
            time.sleep(0.01)
        out['tokens'] = [r.output_tokens for r in reqs]
        drv.stop()

    t = threading.Thread(target=work)
    t.start()
    drv.run()
    t.join()
    return out['tokens']


def generate_rank(rank, world, address, params_path, out_path, oracle):
    """The tiny engine at tp ``world`` over the whole tree in
    ``params_path``: the first chunk's logits, then greedy tokens plain,
    ``quantize=True`` and with ``spec_k`` 3 under an oracle drafter
    proposing ``oracle`` (the expected plain tokens), all through the
    lockstep driver. Rank 0 writes them to ``out_path``."""
    group = mesh.tp_group(rank, world, address, 'cpu')
    params = load_params(params_path)
    result = {}
    # The first step alone: one dense chunk over this rank's slices.
    eng = engine_lib.InferenceEngine(
        CFG, params, engine_lib.EngineConfig(**KW),
        device='cpu', group=group)
    cache = cache_lib.init_cache(CFG.n_layers, 1, 64,
                                 CFG.n_kv_heads // world, CFG.head_dim,
                                 dtype=torch.float32, page=8)
    tokens = torch.tensor(PROMPTS[0] + [0] * 4, dtype=torch.int32)
    _, logits = model_lib.prefill_chunk(
        CFG, eng.params, cache, 0, tokens, 0, len(PROMPTS[0]),
        model_lib.rope_tables(CFG), group)
    result['logits'] = logits.tolist()
    variants = {'plain': {}, 'quantize': dict(quantize=True),
                'spec': dict(spec_k=3)}
    for name, kw in variants.items():
        eng = engine_lib.InferenceEngine(
            CFG, params, engine_lib.EngineConfig(**KW, **kw),
            device='cpu', group=group)
        if name == 'spec':
            eng._drafter = OracleDrafter(PROMPTS, oracle)
        result[name] = _lockstep(eng, group, PROMPTS, NEW)
        metrics = eng.metrics()
        result[name + '_metrics'] = sorted(metrics)
        if name == 'spec':
            result['spec_accepted'] = metrics['spec_accepted_tokens']
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps(result))
    mesh.destroy(group)


def watchdog_rank(rank, world, address, up_path):
    """A tp ``world`` engine on random weights in the lockstep loop;
    rank 0 marks ``up_path`` once the first tick ran on every rank."""
    group = mesh.tp_group(rank, world, address, 'cpu')
    params = engine_lib.init_params_sharded(CFG, world, rank, device='cpu')
    eng = engine_lib.InferenceEngine(
        CFG, params, engine_lib.EngineConfig(**KW),
        device='cpu', group=group)
    drv = multihost.MultihostEngineDriver(eng, group)
    drv.tick()
    if rank == 0:
        pathlib.Path(up_path).write_text('up')
    drv.run()
