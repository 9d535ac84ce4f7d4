"""The readers of the port's program records, on synthetic serving runs:
each value by hand, and None where the step records carry no programs
(a port without them) or the span holds none."""
from __future__ import annotations

import types

import pytest

from perfbench import flops, peaks, programs, spec
from perfbench.weights import Dims, matmul_params

DIMS = Dims(vocab=512, d=64, ffn=128, layers=2, hq=4, hkv=2, hd=16,
            eps=1e-5, theta=1e6)
KIND = peaks.DEFAULT
HBM, BF16 = peaks.peak('hbm_bytes'), peaks.peak('bf16_flops')


def _prog(t, kind, device_s, gap=None, rows=0, chunks=(), kv=0):
    return {'step_idx': 0, 'kind': kind, 'bucket': 1, 't': t,
            'dispatch_s': 1e-4, 'device_s': device_s, 'gap_before_s': gap,
            'rows': rows, 'chunks': [list(c) for c in chunks],
            'kv_tokens': kv}


def _run(with_programs=True):
    progs = [
        # Inside the host span [100, 110).
        _prog(100.5, 'prefill', 0.004, None, 256, [(7, 0, 256)], 256),
        _prog(101.0, 'prefill', 0.002, 0.001, 44, [(7, 256, 44)], 300),
        _prog(101.5, 'decode', 0.010, 0.002, rows=3, kv=900),
        _prog(102.0, 'decode', 0.012, None, rows=4, kv=1200),
        # Inside the profiled sub-window [110, 112).
        _prog(110.5, 'prefill', 0.003, 0.004, 128, [(9, 0, 128)], 128),
        _prog(111.0, 'decode', 0.011, 0.001, rows=2, kv=400),
    ]
    steps = [{'t': p['t'], 'dur_s': 0.02, 'kind': p['kind'],
              **({'programs': [p]} if with_programs else {})}
             for p in progs]
    return types.SimpleNamespace(
        steps=steps, dims=DIMS, device_kind=KIND, host_span=(100.0, 110.0),
        profile_span=(110.0, 112.0),
        profile={'families': {'paged_prefill': {'seconds': 0.001,
                                                'launches': 2}}})


READERS = ('decode_bw_share.chat', 'prefill_mfu.chat',
           'program_gap_share.chat', 'paged_prefill_roofline_counted')


def test_decode_bw_share_by_hand():
    kv_token = DIMS.layers * 2 * DIMS.hkv * DIMS.hd * 2
    weights = matmul_params(DIMS) * 2
    nbytes = 2 * weights + (900 + 3 + 1200 + 4) * kv_token
    want = 100 * nbytes / 0.022 / HBM
    assert spec.reader('decode_bw_share.chat')(_run()) == pytest.approx(want)


def test_prefill_mfu_by_hand():
    # Request 7's second chunk ends its prompt (no chunk starts at 300);
    # its first does not. Request 9's chunk ends its prompt too.
    assert programs.last_chunks(_run()) == {(7, 256), (9, 0)}
    work = (flops.prefill_chunk_flops(DIMS, 0, 256, False)
            + flops.prefill_chunk_flops(DIMS, 256, 44, True))
    want = 100 * work / 0.006 / BF16
    assert spec.reader('prefill_mfu.chat')(_run()) == pytest.approx(want)


def test_program_gap_share_by_hand():
    # The null gap (after an idle tick) counts for nothing.
    assert spec.reader('program_gap_share.chat')(_run()) == \
        pytest.approx(100 * 0.003 / 10.0)


def test_counted_prefill_roofline_reads_the_sub_windows_chunks():
    bound = DIMS.layers * peaks.bound_s(
        *flops.paged_prefill_work(DIMS, 0, 128), KIND)
    assert spec.reader('paged_prefill_roofline_counted')(_run()) == \
        pytest.approx(100 * bound / 0.001)


@pytest.mark.parametrize('name', READERS)
def test_none_without_program_records(name):
    assert spec.reader(name)(_run(with_programs=False)) is None


@pytest.mark.parametrize('name', READERS)
def test_none_where_the_span_holds_no_programs(name):
    run = _run()
    run.host_span = run.profile_span = (0.0, 1.0)
    assert spec.reader(name)(run) is None
