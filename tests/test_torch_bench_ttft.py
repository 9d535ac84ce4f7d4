"""The port's serving sweeps (``skypilot_tpu_torch/bench_ttft.py``: chunked,
concurrency, shared-prefix, disagg) at a tiny size on the CPU: each sweep
prints one well-formed JSON document
with the keys ``PERF.md`` reads, and without ``--device`` it refuses to
run where there is no CUDA (it never falls back to the CPU quietly)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, timeout=300):
    # One intra-op thread for the sweep and the servers it starts: beside
    # a loaded test run, a pool of spinning OpenMP threads per process
    # slows these tiny runs tenfold (the chunked sweep past its timeout).
    return subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.bench_ttft', *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, 'OMP_NUM_THREADS': '1'})


def _doc(out):
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_chunked_sweep_prints_one_json_document():
    doc = _doc(_run('--sweep', 'chunked', '--model', 'tiny', '--device',
                    'cpu', '--slots', '3', '--max-seq-len', '512',
                    '--repeats', '2'))
    assert doc['sweep_mode'] == 'chunked' and doc['card'] == 'cpu'
    level = doc['sweep'][0]
    assert level['concurrency'] == 2
    assert level['aggressor_prompt_tokens'] == 512 - 144
    fused, unfused = level['fused'], level['unfused']
    assert fused['fused_steps'] > 0 and fused['decode_stall_steps'] == 0
    assert unfused['fused_steps'] == 0 and unfused['decode_stall_steps'] > 0
    assert fused['step_programs']['mixed'] >= 1
    assert 'mixed' not in unfused['step_programs']
    for run in (fused, unfused):
        assert run['victim_itl_p99_ms'] >= run['victim_itl_p50_ms'] > 0
        assert run['aggressor_ttft_p50_s'] > 0
        shares = run['step_time_breakdown']
        assert abs(sum(shares[f'{s}_share'] for s in
                       ('dispatch', 'drain', 'readback', 'host')) - 1) < 1e-3
    assert doc['value'] == pytest.approx(
        unfused['victim_itl_p99_ms'] / fused['victim_itl_p99_ms'])
    axis = doc['kv_dtype_axis']
    assert axis['resident_page_ratio'] > 1
    # The prefix half: the int8 pool keeps more of the 30 prefixes.
    assert axis['resident_pages_int8'] > axis['resident_pages_bf16']
    assert axis['prefix_hit_rate_int8'] >= axis['prefix_hit_rate_bf16']
    assert axis['prefix_hit_rate_delta'] == pytest.approx(
        axis['prefix_hit_rate_int8'] - axis['prefix_hit_rate_bf16'],
        abs=1e-4)
    assert axis['prefix_evictions_bf16'] > 0


def _concurrency_sweep(tmp_path, *flags):
    doc = _doc(_run('--sweep', 'concurrency', '--model', 'tiny',
                    '--device', 'cpu', '--slots', '2', '--max-seq-len',
                    '256', '--page-size', '16', '--concurrency', '1', '2',
                    '--requests-per-level', '3', '--new-tokens', '4',
                    '--output', str(tmp_path / 'sweep.json'), *flags))
    assert doc['sweep_mode'] == 'concurrency'
    assert [lv['concurrency'] for lv in doc['sweep']] == [1, 2]
    for lv in doc['sweep']:
        assert lv['samples'] == 3
        assert lv['ttft_p99_s'] >= lv['ttft_p50_s'] > 0
        assert lv['tokens_per_sec'] > 0
    assert doc['cold_first_request_s'] > 0
    assert doc['server_metrics']['integrity'] == 'ok'
    assert json.loads((tmp_path / 'sweep.json').read_text()) == doc
    return doc


def test_concurrency_sweep_prints_one_json_document(tmp_path):
    doc = _concurrency_sweep(tmp_path, '--paged')
    assert doc['paged'] is doc['server_metrics']['paged'] is True


def test_concurrency_sweep_serves_dense_without_paged(tmp_path):
    """The sweep's server takes --paged from the bench, as the reference
    bench's does: without it the replica is dense."""
    doc = _concurrency_sweep(tmp_path)
    assert doc['paged'] is doc['server_metrics']['paged'] is False


def test_quantize_reaches_the_server_and_the_json():
    """--quantize: the server it boots serves int8 weights (its
    param_bytes are under half the bf16 tree's) and the JSON says so."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import quant
    doc = _doc(_run('--sweep', 'concurrency', '--model', 'tiny', '--device',
                    'cpu', '--slots', '2', '--max-seq-len', '128',
                    '--page-size', '16', '--concurrency', '1',
                    '--requests-per-level', '2', '--new-tokens', '2',
                    '--paged', '--quantize'))
    assert doc['quantize'] is True and doc['args']['quantize'] is True
    plain = quant.param_bytes(llama.init_params(
        llama.LlamaConfig.tiny(), torch.Generator().manual_seed(0)))
    assert 0 < doc['server_metrics']['param_bytes'] < plain / 2
    assert 'qdot_int8' in doc['server_metrics']['kernel_launches']


TINY_SERVER = ('--model', 'tiny', '--device', 'cpu', '--slots', '2',
               '--max-seq-len', '256', '--page-size', '16', '--concurrency',
               '1', '2', '--requests-per-level', '3', '--new-tokens', '4',
               '--shared-prefix-tokens', '64')


def test_shared_prefix_sweep_prints_one_json_document():
    doc = _doc(_run('--sweep', 'shared-prefix', *TINY_SERVER))
    assert doc['sweep_mode'] == 'shared-prefix'
    assert [lv['concurrency'] for lv in doc['sweep']] == [1, 2]
    for lv in doc['sweep']:
        assert lv['cold']['samples'] == lv['shared']['samples'] == 3
        assert lv['prefix_hit_rate'] == 1.0
        # Each shared request attaches the 4 full pages of its block.
        assert lv['tokens_prefill_saved'] == 3 * 64
        assert lv['ttft_improvement_x'] > 0
        assert lv['itl_ratio_shared_over_cold'] > 0
    assert doc['value'] == doc['sweep'][0]['ttft_improvement_x']
    assert doc['server_metrics']['step_programs']['cow'] == 0


def test_disagg_sweep_prints_one_json_document():
    doc = _doc(_run('--sweep', 'disagg', *TINY_SERVER, '--n-pages', '40'))
    assert doc['sweep_mode'] == 'disagg' and doc['kv_dtype'] == 'int8'
    roles = doc['server_metrics']
    assert roles['prefill']['role'] == 'prefill'
    assert roles['decode']['role'] == 'decode'
    for lv in doc['sweep']:
        # The first request of the transfer cohort pulled the block; the
        # donor exported what the decode server imported.
        assert lv['kv_transfers'] >= 1 and lv['kv_transfer_failures'] == 0
        assert lv['donor_exports'] == lv['kv_transfers']
        assert lv['kv_transfer_bytes'] > 0
        assert lv['transfer_hit_rate'] == 1.0
        assert lv['recompute_hit_rate'] < 1.0
        assert lv['recompute_first_ttft_s'] > 0
        assert lv['transfer_first_ttft_s'] > 0
    assert doc['transfer_p99_s'] > 0
    assert doc['value'] == doc['sweep'][0]['first_ttft_improvement_x']


def test_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip('checks the refusal where there is no CUDA')
    out = _run('--sweep', 'chunked', '--model', 'tiny', timeout=120)
    assert out.returncode != 0
    assert 'CUDA is not available' in out.stderr
    assert not out.stdout.strip()
