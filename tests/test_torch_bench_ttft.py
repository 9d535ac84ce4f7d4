"""The port's serving sweeps (``skypilot_tpu_torch/bench_ttft.py``: chunked,
concurrency, shared-prefix, disagg, coldstart, speculative, tenants and
chaos-resume) at a tiny size on the CPU: each sweep prints one
well-formed JSON document with the reference's head metric and the keys
``PERF.md`` reads, and without ``--device`` it refuses to run where there
is no CUDA (it never falls back to the CPU quietly)."""
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


SMALL = ('--model', 'tiny', '--device', 'cpu', '--slots', '2',
         '--max-seq-len', '256', '--page-size', '16')


def test_coldstart_sweep_boots_twice_on_one_build_directory():
    doc = _doc(_run('--sweep', 'coldstart', *SMALL))
    assert doc['metric'] == 'coldstart_ready_ratio_cold_over_warm'
    cold, warm = doc['sweep']
    assert doc['value'] == pytest.approx(cold['time_to_ready_s']
                                         / warm['time_to_ready_s'])
    for boot in (cold, warm):
        assert boot['first_token_s'] > boot['time_to_ready_s'] > 0
        assert set(boot['stamps']) == {'weights_loaded', 'compiled'}
        assert boot['stamps']['compiled']['total_s'] >= 0
        # --compile-cache-dir reached the server; the CPU builds nothing.
        assert boot['kernel_build_dir'] == cold['kernel_build_dir']
        assert 'sky-tpu-kernels-' in boot['kernel_build_dir']
        assert boot['nvcc_s'] == {} and boot['libraries_added'] == []
        assert boot['library_mtimes_before'] == \
            boot['library_mtimes_after'] == {}


def test_speculative_sweep_runs_verify_and_keeps_greedy_tokens():
    doc = _doc(_run('--sweep', 'speculative', *SMALL, '--concurrency', '2',
                    '--requests-per-level', '3', '--spec-max-new', '16'))
    assert doc['metric'] == 'speculative_itl_improvement_x'
    assert doc['spec_k'] == 6 and doc['bit_identical'] is True
    level = doc['sweep'][0]
    assert level['counters']['spec_steps'] > 0       # verify ran
    assert level['accepted_len_mean'] >= 1
    assert 0 < level['spec_accept_rate'] <= 1
    assert level['tokens_per_step'] > 1
    assert doc['value'] == level['itl_improvement_x'] > 0
    assert level['spec_off']['samples'] == level['spec_on']['samples'] == 3
    assert doc['server_metrics']['step_programs']['verify'] == 1


def test_tenants_sweep_reports_both_tenants():
    doc = _doc(_run('--sweep', 'tenants', *SMALL, '--concurrency', '2',
                    '--trace-duration', '2', '--new-tokens', '4'))
    assert doc['metric'] == 'tenants_victim_ttft_p99_s'
    assert doc['scheduler'] == 'wfq' and doc['max_queue_requests'] == 8
    level = doc['sweep'][0]
    assert set(level['tenants']) == {'victim', 'aggressor'}
    assert level['samples'] == level['trace_events'] == sum(
        t['issued'] for t in level['tenants'].values())
    assert level['tenants']['aggressor']['issued'] > \
        level['tenants']['victim']['issued']
    vict = level['tenants']['victim']
    assert doc['value'] == vict['ttft_p99_s'] > 0
    assert level['replica_requests_shed'] == sum(
        t['shed'] for t in level['tenants'].values())
    assert level['replica_tenants_decode_tokens']['aggressor'] > 0


def test_chaos_resume_sweep_splices_bitwise():
    doc = _doc(_run('--sweep', 'chaos-resume', *SMALL, '--concurrency', '2',
                    '--requests-per-level', '4', '--new-tokens', '16',
                    '--kill-after-chunks', '3'))
    assert doc['metric'] == 'chaos_resume_completed_rate'
    assert doc['value'] == 1.0 and doc['resumes'] >= 1
    assert doc['bit_identical'] is True
    level = doc['sweep'][0]
    assert level['uninterrupted']['resumes'] == 0
    assert level['chaos']['resumed_streams'] == level['resumes'] >= 1
    assert level['parted'] == []
    assert doc['resume_added_p99_s'] == level['resume_added_p99_s']
    # Each cut leg was cancelled on the replica when the client hung up.
    assert doc['server_metrics']['requests_cancelled'] >= 1


def test_tokenizer_128k_and_output_resolution(tmp_path, monkeypatch):
    """``--tokenizer 128k`` writes the reference's derived tokenizer.json
    (loading it needs the tokenizers package: only the file is checked);
    ``--output auto`` takes the next free revision and an existing path
    needs ``--clobber``."""
    from skypilot_tpu.infer import server as jserver
    from skypilot_tpu_torch import bench_ttft
    monkeypatch.setenv('SKY_TPU_HOME', str(tmp_path / 'home'))
    path = bench_ttft.resolve_tokenizer('128k')
    assert path == str(tmp_path / 'home' / 'cache' / 'tokenizer_128k.json')
    doc = json.loads(pathlib.Path(path).read_text())
    assert len(doc['model']['vocab']) == 128_256
    want = jserver.synthesize_wordlevel_tokenizer(
        128_256, str(tmp_path / 'want.json'))
    assert pathlib.Path(want).read_bytes() == pathlib.Path(path).read_bytes()
    assert bench_ttft.resolve_tokenizer('tok.json') == 'tok.json'
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'TTFT_r03.json').write_text('{}')
    assert bench_ttft.resolve_output('auto', False) == 'TTFT_r04.json'
    with pytest.raises(SystemExit, match='clobber'):
        bench_ttft.resolve_output('TTFT_r03.json', False)
    assert bench_ttft.resolve_output('TTFT_r03.json', True) == \
        'TTFT_r03.json'


def test_long_prompt_lane_reports_apart():
    doc = _doc(_run('--sweep', 'concurrency', *SMALL, '--concurrency', '2',
                    '--requests-per-level', '8', '--new-tokens', '4',
                    '--long-prompt-tokens', '100'))
    assert doc['long_prompt_tokens'] == 100
    [lv] = doc['sweep']
    assert lv['samples'] == 8 and lv['long_samples'] == 1
    assert lv['long_ttft_p50_s'] > 0 and lv['short_ttft_p50_s'] > 0


def test_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip('checks the refusal where there is no CUDA')
    out = _run('--sweep', 'chunked', '--model', 'tiny', timeout=120)
    assert out.returncode != 0
    assert 'CUDA is not available' in out.stderr
    assert not out.stdout.strip()


@pytest.mark.parametrize('name', ['coldstart', 'speculative', 'tenants',
                                  'chaos-resume'])
def test_new_sweeps_refuse_without_cuda(name):
    """Without ``--device`` the sweep asks for the card and, where there
    is none, raises before it starts any server."""
    if torch.cuda.is_available():
        pytest.skip('checks the refusal where there is no CUDA')
    from skypilot_tpu_torch import bench_ttft
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        bench_ttft.sweep(['--sweep', name, '--model', 'tiny'])
