"""The controls at the cells' own sizes, on the card (``-m chip``): a
sound run passes its limits, and the control and the faults fail one of
them. Each skips where there is no CUDA device."""
from __future__ import annotations

import pytest

from perfbench import controls, spec

pytestmark = pytest.mark.chip


def _fails(cell, numbers):
    limits = cell.params['check']['limits']
    return [k for k, lim in limits.items()
            if ('max' in lim and numbers[k] > lim['max'])
            or ('min' in lim and numbers[k] < lim['min'])]


@pytest.mark.parametrize('name', ['serve-chat'])
def test_serving_program_passes_and_int8_control_fails(name, cuda):
    cell = spec.load_cell(name)
    assert _fails(cell, controls.serve_readings(cell, 4_000_000_001, 15.0,
                                                control=False)) == []
    assert _fails(cell, controls.serve_readings(cell, 4_000_000_002, 15.0,
                                                control=True))


@pytest.mark.parametrize('kind', ['program', 'control', 'half_batch'])
def test_training_control_and_half_batch_fail(kind, cuda):
    cell = spec.load_cell('train-4k')
    fails = _fails(cell, controls.train_readings(cell, 4_000_000_011, kind))
    assert (fails == []) == (kind == 'program'), fails
