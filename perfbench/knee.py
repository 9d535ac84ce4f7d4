"""Find the highest arrival rate a serving cell's replica sustains.

    python3 -m perfbench.knee --workload serve-chat --seed 7 \\
        --rates 4,5,6,7,8 --seconds 30 [--orders 1,2] [--seeds 7,8] \\
        [--out chiprun_out/knee.json]

One replica (the cell's own, as ``perfbench.run`` starts it) takes the
cell's open-loop traffic at each rate in turn, ``--seconds`` a level,
with the replica drained between levels. ``--seconds``, ``--orders``
(the mix's ``order_seed``; its own by default) and ``--seeds`` (the
token ids; ``--seed`` by default) take lists too, and the levels run
over every combination: so one replica also shows whether the mix's
order is typical of others at the cell's rate, and how a window's
length moves the spread of the cell's tails. A level's backlog grows when
the replica's queue (the flight recorder's ``queue_depth``) is deeper in
the level's last third than in its first, and when requests due late in
the level wait longer for their first token than those due early. The
knee is the highest rate at which neither grows; a cell sets its rate
from it once, as a number in its file. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import itertools
import statistics
import sys
import time
import types

from perfbench import client as client_lib
from perfbench import spec as spec_lib
from perfbench import traffic
from perfbench.serve_cell import Child
from perfbench.traffic import open as open_lib
from perfbench.weights import Dims


def level(port: int, child: Child, params, seed: int, seconds: float,
          vocab: int, drain_wait_s: float):
    t0 = time.time() + 0.25
    recs = open_lib.run(port, params, seed, seconds, vocab, t0,
                        drain_wait_s)
    steps = [s for s in child.ask('stats')['steps']
             if t0 <= s['t'] < t0 + seconds]
    third = seconds / 3

    def depth(lo, hi):
        d = [s['queue_depth'] for s in steps if lo <= s['t'] - t0 < hi]
        return statistics.fmean(d) if d else 0.0

    counted = [r for r in recs if r.counted]
    view = types.SimpleNamespace(counted=counted, t1=t0 + seconds,
                                 drain_wait_s=drain_wait_s)
    early = [r.ttft() for r in counted if r.ttft() is not None
             and r.due - t0 < third]
    late = [r.ttft() for r in counted if r.ttft() is not None
            and r.due - t0 >= 2 * third]
    out = {
        'rate_per_s': params['rate_per_s'],
        'order_seed': params['order_seed'],
        'seed': seed,
        'seconds': seconds,
        'requests': len(counted),
        'finished': sum(r.finished for r in counted),
        'queue_depth_mean': depth(0, seconds),
        'queue_depth_first_third': depth(0, third),
        'queue_depth_last_third': depth(2 * third, seconds),
        'ttft_p50_early_s': statistics.median(early) if early else None,
        'ttft_p50_late_s': statistics.median(late) if late else None,
        # The cell's own end-to-end readers, over the level's window.
        'ttft_p90_s': spec_lib.reader('ttft_p90_s')(view),
        'itl_p99_ms': spec_lib.reader('itl_p99_ms')(view),
        'tokens_per_s': sum(n for r in recs for t, n in r.arrivals
                            if t0 <= t < t0 + seconds) / seconds,
    }
    # Let the replica run dry before the next level.
    while True:
        steps = child.ask('stats')['steps']
        if not steps or time.time() - steps[-1]['t'] > 1.0:
            break
        time.sleep(0.5)
    return out


def _floats(text):
    return [float(x) for x in text.split(',')] if text else []


def _ints(text):
    return [int(x) for x in text.split(',')] if text else []


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--rates', required=True)
    parser.add_argument('--seconds', default='30')
    parser.add_argument('--orders', help="order_seed values (default: "
                        "the mix's own)")
    parser.add_argument('--seeds', help='token seeds (default: --seed)')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--config')
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    cell = spec_lib.load_cell(args.workload)
    config_path = args.config or str(spec_lib.ROOT / next(
        c['file'] for c in spec_lib.benchmark()['configs']
        if c['name'] == cell.entry['config']))
    with open(config_path) as f:
        dims = Dims.of(json.load(f))
    params = dict(cell.traffic, **cell.params.get('traffic', {}))
    child = Child(cell, args.seed, args.device, cell.params['engine'],
                  config_path)
    results = []
    try:
        ready = child.read(1100)
        port = ready['port']
        warm = client_lib.Record(
            idx=-1, prompt=traffic.token_ids(traffic.rng(args.seed, 7), 64,
                                             dims.vocab),
            max_new=4, due=time.time())
        client_lib.stream(port, warm)
        grid = itertools.product(
            _floats(args.seconds), _floats(args.rates),
            _ints(args.orders) or [params['order_seed']],
            _ints(args.seeds) or [args.seed])
        for seconds, rate, order, seed in grid:
            res = level(port, child,
                        dict(params, rate_per_s=rate, order_seed=order),
                        seed, seconds, dims.vocab, 30.0)
            print(json.dumps(res), flush=True)
            results.append(res)
    finally:
        child.close()
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
