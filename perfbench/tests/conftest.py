"""The benchmark's own tests: ``python3 -m pytest perfbench/tests -q``
on the CPU; on the card, ``python3 -m pytest perfbench/tests -m chip
-q`` runs the tests that need it (each skips inside a fixture where
there is no CUDA device)."""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A configuration small enough for the CPU: the published key names, the
# replica's 2,048 rows.
TINY = {
    'name': 'tiny', 'source': 'test', 'vocab_size': 512, 'hidden_size': 64,
    'intermediate_size': 128, 'num_hidden_layers': 2,
    'num_attention_heads': 4, 'num_key_value_heads': 2, 'head_dim': 16,
    'max_position_embeddings': 2048, 'rms_norm_eps': 1e-5,
    'rope_theta': 1e6, 'torch_dtype': 'bfloat16',
}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'chip: needs a CUDA device (skips elsewhere, from a '
        'fixture)')


# Cells whose files are ready but which BENCHMARK.json does not list
# (PERF.md says why): their configuration and traffic mix.
UNLISTED = {'serve-reasoning': ('mistral-7b-v0.3-replica', 'reasoning'),
            'train-16k': ('mistral-7b-v0.3-ft-stage', 'ft-16k')}


def load_cell(name):
    """``spec.load_cell``, or for an unlisted cell the same from its
    files, with the end-to-end and per-layer metrics it would report."""
    from perfbench import spec
    if name not in UNLISTED:
        return spec.load_cell(name)
    config, mix = UNLISTED[name]
    bench = spec.benchmark()
    files = {c['name']: c['file'] for c in bench['configs']}
    with open(ROOT / files[config]) as f:
        config_file = json.load(f)
    with open(spec.HERE / 'traffic' / f'{mix}.json') as f:
        traffic = json.load(f)
    with open(spec.HERE / 'workloads' / f'{name}.json') as f:
        params = json.load(f)
    e2e = [m for m in bench['end_to_end'] if m['name'] == 'setup_s']
    e2e.append({'name': 'output_tokens_per_s' if params['driver'] == 'serve'
                else 'train_tokens_per_s', 'unit': 'tokens/s'})
    return spec.Cell(name=name, entry={'name': name, 'config': config,
                                       'traffic': mix, 'chips': 1},
                     params=params, config=config_file, traffic=traffic,
                     end_to_end=e2e, per_layer=[])


@pytest.fixture
def tiny_config(tmp_path):
    path = tmp_path / 'tiny.json'
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')
