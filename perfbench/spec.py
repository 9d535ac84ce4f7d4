"""Where the benchmark's parts live, and how they are found by name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; its own parameters sit in
``workloads/<cell>.json``. Each metric has a reader in
``metrics/<name>.py``, or, for a quantity split by cell kind
(``step_host_ms.chat``), in ``metrics/<name before the first dot>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# The kernel build directory and the other caches of the program: fixed
# paths inside the checkout, so that only a checkout's first run builds.
BUILD_DIR = HERE / '_build'
CACHE_DIR = HERE / '_cache'


def _json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(ROOT / 'BENCHMARK.json')


@dataclasses.dataclass
class Cell:
    """One cell with everything it names, loaded."""
    name: str
    entry: Dict[str, Any]          # its BENCHMARK.json workloads entry
    params: Dict[str, Any]         # workloads/<cell>.json
    config: Dict[str, Any]         # configs/<config>.json
    traffic: Dict[str, Any]        # traffic/<mix>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def chips(self) -> int:
        return int(self.entry['chips'])


def _applies(metric: Dict[str, Any], cell: str,
             e2e_names: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: named in its
    ``workloads``, or, without that key, in every cell that reports the
    end-to-end metric it moves (an end-to-end metric without the key is
    reported everywhere)."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    if 'moves' in metric:
        return metric['moves'] in e2e_names
    return True


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    entries = {w['name']: w for w in bench['workloads']}
    if name not in entries:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json '
                         f'(have: {", ".join(sorted(entries))})')
    entry = entries[name]
    configs = {c['name']: c for c in bench['configs']}
    config = _json(ROOT / configs[entry['config']]['file'])
    e2e = [m for m in bench['end_to_end'] if _applies(m, name, [])]
    names = [m['name'] for m in e2e]
    per_layer = [m for m in bench['per_layer']
                 if _applies(m, name, names)]
    return Cell(name=name, entry=entry,
                params=_json(HERE / 'workloads' / f'{name}.json'),
                config=config,
                traffic=_json(HERE / 'traffic' / f'{entry["traffic"]}.json'),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(run)`` function of ``metric``'s reader module."""
    path = HERE / 'metrics' / f'{metric}.py'
    if not path.exists():
        path = HERE / 'metrics' / f'{metric.split(".", 1)[0]}.py'
    spec = importlib.util.spec_from_file_location(
        f'perfbench.metrics.{path.stem.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
