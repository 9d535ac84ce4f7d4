"""Every cell end to end on the CPU at a tiny size, through the same
``perfbench.run.execute`` a chip run takes (only the look for a card is
skipped); then the same runs with the timed path broken underneath,
which ``correct`` has to catch."""
from __future__ import annotations

import copy
import dataclasses
import math

import pytest

from conftest import load_cell
from perfbench import run as run_lib

SMALL_OUT = {'dist': 'lognormal', 'median': 64, 'sigma': 0.3, 'min': 60,
             'max': 96}
SMALL = {
    'serve-chat': {'traffic': {'rate_per_s': 3.0, 'output': SMALL_OUT},
                   'drain_wait_s': 30},
    'serve-reasoning': {'traffic': {'clients': 4, 'output': SMALL_OUT}},
    'train-4k': {'traffic': {'batch': 2, 'seq': 64}, 'min_step_s': 0.001},
    'train-16k': {'traffic': {'batch': 1, 'seq': 128}, 'min_step_s': 0.001},
}


def _tiny_cell(name):
    cell = load_cell(name)
    over = SMALL[name]
    params = copy.deepcopy(cell.params)
    traffic = dict(cell.traffic)
    if cell.params['driver'] == 'serve':
        params['traffic'] = dict(params.get('traffic', {}), **over['traffic'])
        # Short outputs: sample enough of them for the check's minimum.
        params['check']['sample_requests'] = 4
    else:
        traffic.update(over['traffic'])
    params.update({k: v for k, v in over.items() if k != 'traffic'})
    return dataclasses.replace(cell, params=params, traffic=traffic)


def _execute(name, tiny_config, trace=False, seconds=3.0):
    return run_lib.execute(_tiny_cell(name), 2 ** 31 + 77, seconds, trace,
                           device='cpu', config_path=tiny_config)


# The numbers whose readings follow the size: the cell's limits were set
# at its own size, so at the tiny one these are only reported.
SIZED = {'tokens_checked', 'change_leaf_gap', 'loss_gap'}


def _within(check, names):
    return all(check[k]['value'] <= check[k]['max'] if 'max' in check[k]
               else check[k]['value'] >= check[k]['min'] for k in names)


@pytest.mark.parametrize('name', sorted(SMALL))
def test_cell_runs_end_to_end_on_the_cpu(name, tiny_config):
    res = _execute(name, tiny_config)
    cell = load_cell(name)
    check = res['check']
    assert set(check) == set(cell.params['check']['limits'])
    assert all(math.isfinite(c['value']) for c in check.values())
    assert _within(check, set(check) - SIZED), check
    assert set(res['metrics']) == {m['name'] for m in cell.end_to_end}
    assert res['attempted'] > 0 and res['failed'] == 0
    assert list(res)[-1] == 'check'


@pytest.mark.parametrize('name', ['serve-chat', 'train-4k'])
def test_traced_run_reads_the_host_side_layers(name, tiny_config):
    res = _execute(name, tiny_config, trace=True)
    cell = load_cell(name)
    # On the CPU there is no device trace: the readers of device metrics
    # find nothing and leave their metrics out.
    host_side = {m['name'] for m in cell.per_layer
                 if m['source'] != 'device_trace'}
    assert host_side <= set(res['metrics'])
    assert 'busy_s' in res['device'] and 'breakdown' in res


def _break_train_step(monkeypatch, how):
    from skypilot_tpu_torch.train import trainer
    real = trainer.make_train_step

    def broken_factory(config, opt, mesh=None):
        step = real(config, opt, mesh)

        def broken(state, batch):
            if how == 'unchanged':
                _, metrics = step(copy.deepcopy(state), batch)
                return state, metrics
            tokens = batch['tokens']
            mask = (__import__('torch').arange(tokens.numel())
                    < tokens.numel() // 2).reshape(tokens.shape)
            return step(state, dict(batch, mask=mask.float()))
        return broken
    monkeypatch.setattr(trainer, 'make_train_step', broken_factory)


@pytest.mark.parametrize('how,caught', [
    ('unchanged', ['grad_leaf_gap', 'grad_sample_gap']),
    ('half_batch', ['grad_norm_gap', 'grad_sample_gap'])])
def test_broken_train_step_is_not_correct(how, caught, tiny_config,
                                          monkeypatch):
    _break_train_step(monkeypatch, how)
    res = _execute('train-4k', tiny_config, seconds=1.0)
    assert not res['correct']
    for name in caught:
        assert not _within(res['check'], [name]), (name, res['check'])


def test_altered_token_is_not_correct(tiny_config, tmp_path, monkeypatch):
    # The replica's process alters the fourth token of every request
    # where the engine produces it (its pair row), before it is streamed.
    from perfbench import controls
    monkeypatch.setenv('PYTHONPATH', '')
    controls.altered_token_env(str(tmp_path))
    res = _execute('serve-chat', tiny_config)
    assert not res['correct']
    assert not _within(res['check'], ['served_logit_gap']), res['check']


def test_a_forbidden_module_in_the_replica_gives_no_result(
        tiny_config, tmp_path, monkeypatch):
    # The replica's process loads a module named jax at its start: the
    # run's own process never does, so only the replica's report shows it.
    (tmp_path / 'sitecustomize.py').write_text(
        "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv('PYTHONPATH', str(tmp_path))
    with pytest.raises(run_lib.ForbiddenModules,
                       match=r'jax \(replica process\)'):
        _execute('serve-chat', tiny_config)
