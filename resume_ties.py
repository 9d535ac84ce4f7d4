"""Where chip_smoke.py phase 5i's spliced streams part from their twins.

Phase 5i cuts every second stream of a chaos-resume level (16 requests at
4 in flight, 32 new tokens) after 6 streamed lines and resumes it with
the tokens delivered so far. A line carries the tokens the engine has
emitted since the last one, so the cut lands after 6 or more tokens,
and where it lands decides which near-ties of the twin the resume's
recomputed K/V flip. This script measures that on one card:

1. the replica at 5i's flags (Llama-3-8B, int8 weights, random seed-0)
   runs 5i's sweeps, then the chaos level REPEATS times: each repeat's
   cuts, its partings, and whether the uninterrupted twins changed
   between repeats;
2. an in-process engine of the same flags and weights generates the 8
   cut prompts' twins twice (are they the same?) and resumes them from
   every cut 1..31: the partings at each cut, each with
   ``chip_smoke.parting_tie``.

Run it on the card from the root of the repo::

    python3 resume_ties.py

It prints a summary and writes ``chiprun_out/resume_ties.json``.
"""
import json
import sys
import tempfile
import time

import torch

import chip_smoke as cs
from skypilot_tpu_torch import bench_ttft
from skypilot_tpu_torch.infer import model as model_lib
from skypilot_tpu_torch.infer import paged_cache as pc_lib
from skypilot_tpu_torch.infer import server as server_lib

REPEATS = 6


def first_diff(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def server_repeats(args) -> list:
    """5i's sweeps on a booted replica, then REPEATS chaos levels: each
    one's twins, spliced streams and cuts."""
    vocab = server_lib.MODELS['8b']().vocab_size

    def then(base):
        gen, met = base + '/generate', base + '/metrics'
        cs.spec_check(base, vocab)
        bench_ttft.warm_speculative(gen, 8, 16, 64)
        bench_ttft.speculative_level(gen, met, 8, 16, 6, 64)
        bench_ttft.tenant_level(gen, met, 4, args.trace_seed, 3.0)
        reps = []
        for _ in range(REPEATS):
            _, want = bench_ttft._chaos_pass(gen, 4, 16, cs.SWEEP_NEW, None)
            _, got = bench_ttft._chaos_pass(gen, 4, 16, cs.SWEEP_NEW,
                                            args.kill_after_chunks)
            reps.append({'want': [w['tokens'] for w in want],
                         'got': [g['tokens'] for g in got],
                         'cut_at': [g['cut_at'] for g in got]})
        return reps

    with tempfile.TemporaryDirectory(prefix='resume-ties-') as cache:
        return bench_ttft.coldstart_boot(args, torch.device('cuda', 0), cache,
                                         0, then, cs.SWEEP_QUEUE)['then']


def main() -> int:
    if not torch.cuda.is_available():
        print('resume_ties: needs a CUDA card', file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.card_line()
    args = bench_ttft.parse_args(['--sweep', 'coldstart', '--device', 'cuda',
                                  '--boot-timeout', '600', *cs.SWEEP_BENCH])
    reps = server_repeats(args)
    eng = server_lib.engine_from_args(
        server_lib.parse_args(['--port', '0', *cs.SWEEP_REPLICA]))
    cfg = eng.config
    rope = model_lib.rope_tables(cfg, 'cuda')
    prompts = [list(f'chaos request {i}'.encode()) for i in range(16)]

    def run(subs):
        reqs = [eng.submit(p, max_new_tokens=cs.SWEEP_NEW, resume_tokens=r)
                for p, r in subs]
        while not all(q.done for q in reqs):
            eng.step()
        return [q.output_tokens for q in reqs]

    def parted(requests, twins, spliced):
        out = []
        for i, w, g in zip(requests, twins, spliced):
            j = first_diff(g, w)
            if j is not None:
                out.append({'request': i, **cs.parting_tie(
                    torch, model_lib, pc_lib, cfg, eng.params, rope,
                    prompts[i], w, g, j)})
        return out

    server = []
    for rep in reps:
        cut = [i for i, c in enumerate(rep['cut_at']) if c is not None]
        resumed = run([(prompts[i], rep['got'][i][:rep['cut_at'][i]])
                       for i in cut])
        server.append({
            'cut_at': {i: rep['cut_at'][i] for i in cut},
            'spliced_is_engine_resume': all(
                r == rep['got'][i] for i, r in zip(cut, resumed)),
            'twins_as_repeat_0': rep['want'] == reps[0]['want'],
            'parted': parted(cut, [rep['want'][i] for i in cut],
                             [rep['got'][i] for i in cut])})
    even = list(range(0, 16, 2))
    twins = run([(prompts[i], None) for i in even])
    twins_again = run([(prompts[i], None) for i in even]) == twins
    cuts = []
    for cut in range(1, cs.SWEEP_NEW):
        got = run([(prompts[i], t[:cut]) for i, t in zip(even, twins)])
        cuts.append({'cut': cut, 'parted': parted(even, twins, got)})
    out = {'card': card, 'flags': cs.SWEEP_REPLICA, 'server': server,
           'in_process_twins_repeat': twins_again, 'cuts': cuts,
           'seconds': time.perf_counter() - t0}
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / 'resume_ties.json').write_text(json.dumps(out))

    def brief(ps):
        return [(p['request'], p['step'], round(p['bf16_steps'], 3))
                for p in ps]

    print(card)
    for k, row in enumerate(server):
        print(f'server repeat {k}: cuts {sorted(set(row["cut_at"].values()))}'
              f', spliced = engine resume {row["spliced_is_engine_resume"]}'
              f', twins as repeat 0 {row["twins_as_repeat_0"]}, parted '
              f'(request, step, bf16 steps) {brief(row["parted"])}')
    print(f'in-process twins the same twice: {twins_again}')
    for row in cuts:
        print(f'cut {row["cut"]}: {len(row["parted"])} parted '
              f'{brief(row["parted"])}')
    steps = [p['bf16_steps'] for row in cuts + server for p in row['parted']]
    print(json.dumps({
        'parted_per_cut': [len(row['parted']) for row in cuts],
        'max_bf16_steps': max(steps) if steps else None,
        'seconds': out['seconds']}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
