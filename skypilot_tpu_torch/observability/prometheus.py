"""Prometheus text exposition of a replica's ``/metrics`` (a copy of
the replica half of ``skypilot_tpu/observability/prometheus.py``:
``replica_exposition``, ``_labels``, ``_emit_scalars`` and
``render_replica``, with the same family names, so one scrape config
serves JAX and torch replicas alike).

Exposed families are an explicit literal map, never a mechanical
flatten: exposition names are a public API. Label values are
client-controlled (tenant ids ride ``X-SkyTpu-Tenant``): every label
passes through :func:`~skypilot_tpu_torch.observability.store.
sanitize_label`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from skypilot_tpu_torch.observability import store as store_lib


def replica_exposition() -> Dict[str, Tuple[str, str]]:
    """Scalar replica ``/metrics`` keys -> (family, type)."""
    return {
        'decode_steps': ('sky_tpu_engine_decode_steps', 'counter'),
        'decode_tokens': ('sky_tpu_engine_decode_tokens', 'counter'),
        'decode_tokens_per_sec': (
            'sky_tpu_engine_decode_tokens_per_sec', 'gauge'),
        'num_waiting': ('sky_tpu_engine_num_waiting', 'gauge'),
        'num_active': ('sky_tpu_engine_num_active', 'gauge'),
        'queued_tokens': ('sky_tpu_engine_queued_tokens', 'gauge'),
        'tokens_per_step': (
            'sky_tpu_engine_tokens_per_step', 'gauge'),
        'tokens_in_flight': (
            'sky_tpu_engine_tokens_in_flight', 'gauge'),
        'ttft_p50_s': ('sky_tpu_engine_ttft_p50_seconds', 'gauge'),
        'queue_wait_p50_ms': (
            'sky_tpu_engine_queue_wait_p50_ms', 'gauge'),
        'queue_wait_p99_ms': (
            'sky_tpu_engine_queue_wait_p99_ms', 'gauge'),
        'requests_abandoned': (
            'sky_tpu_engine_requests_abandoned', 'counter'),
        'requests_expired': (
            'sky_tpu_engine_requests_expired', 'counter'),
        'requests_cancelled': (
            'sky_tpu_engine_requests_cancelled', 'counter'),
        'requests_shed': ('sky_tpu_server_requests_shed', 'counter'),
        'server_inflight': ('sky_tpu_server_inflight', 'gauge'),
        'draining': ('sky_tpu_server_draining', 'gauge'),
        'prefill_tokens': (
            'sky_tpu_engine_prefill_tokens', 'counter'),
        'fused_steps': ('sky_tpu_engine_fused_steps', 'counter'),
        'decode_stall_steps': (
            'sky_tpu_engine_decode_stall_steps', 'counter'),
        'spec_steps': ('sky_tpu_engine_spec_steps', 'counter'),
        'spec_drafted_tokens': (
            'sky_tpu_engine_spec_drafted_tokens', 'counter'),
        'spec_accepted_tokens': (
            'sky_tpu_engine_spec_accepted_tokens', 'counter'),
        'spec_accept_rate': (
            'sky_tpu_engine_spec_accept_rate', 'gauge'),
        'accepted_len_mean': (
            'sky_tpu_engine_accepted_len_mean', 'gauge'),
        'pages_total': ('sky_tpu_engine_pages_total', 'gauge'),
        'pages_free': ('sky_tpu_engine_pages_free', 'gauge'),
        'preemptions': ('sky_tpu_engine_preemptions', 'counter'),
        'prefix_hit_rate': (
            'sky_tpu_engine_prefix_hit_rate', 'gauge'),
        'prefix_cached_pages': (
            'sky_tpu_engine_prefix_cached_pages', 'gauge'),
        'prefix_evictions': (
            'sky_tpu_engine_prefix_evictions', 'counter'),
        'stepline_steps': (
            'sky_tpu_engine_stepline_steps', 'counter'),
        'stepline_dumps': (
            'sky_tpu_engine_stepline_dumps', 'counter'),
        # Data integrity: the string-valued ``integrity`` state renders
        # as a labeled state-set, not a scalar.
        'sdc_events_total': (
            'sky_tpu_engine_sdc_events_total', 'counter'),
        # Disaggregated prefill/decode.
        'kv_transfers_total': (
            'sky_tpu_engine_kv_transfers_total', 'counter'),
        'kv_transfer_bytes': (
            'sky_tpu_engine_kv_transfer_bytes', 'counter'),
        'kv_transfer_failures': (
            'sky_tpu_engine_kv_transfer_failures', 'counter'),
        'kv_transfer_p99_s': (
            'sky_tpu_engine_kv_transfer_p99_seconds', 'gauge'),
        'prefix_indexed_pages': (
            'sky_tpu_engine_prefix_indexed_pages', 'gauge'),
    }


def label_families() -> Dict[str, Tuple[str, str]]:
    """Labeled replica families: logical name -> (family, type)."""
    return {
        'engine_integrity': (
            'sky_tpu_engine_integrity_state', 'gauge'),
        'engine_tenant_queue_depth': (
            'sky_tpu_engine_tenant_queue_depth', 'gauge'),
        'engine_tenant_decode_tokens': (
            'sky_tpu_engine_tenant_decode_tokens', 'counter'),
        'engine_tenant_requests_shed': (
            'sky_tpu_engine_tenant_requests_shed', 'counter'),
        'engine_tenant_ttft_p99': (
            'sky_tpu_engine_tenant_ttft_p99_seconds', 'gauge'),
    }


def _labels(pairs: Mapping[str, Any]) -> str:
    inner = ','.join(
        f'{k}="{store_lib.sanitize_label(v)}"'
        for k, v in sorted(pairs.items()))
    return '{' + inner + '}'


class _Doc:
    """Accumulates exposition samples grouped by family: the text
    format requires ALL lines of one family to form a single
    contiguous group under its # TYPE header, but the renderers
    iterate entity-major (per tenant, per replica, per objective) —
    so samples collect per family here and emit family-major, in
    first-add order, at ``text()`` time."""

    def __init__(self) -> None:
        # family -> (type, {label-suffix: value}); dicts preserve
        # insertion order, so families (and samples within one)
        # render in the order renderers add them.
        self._families: Dict[str, Tuple[str, Dict[str, Any]]] = {}

    def add(self, family: str, mtype: str, value: Any,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        if value is None:
            return
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        group = self._families.get(family)
        if group is None:
            group = self._families[family] = (mtype, {})
        suffix = _labels(labels) if labels else ''
        # Post-sanitization label COLLISIONS (two tenant ids mapping
        # to one label value) must not emit duplicate series — a
        # scrape containing duplicates is rejected wholesale, a
        # client-triggerable observability outage. Counters fold by
        # sum (the collided series' true total); gauges keep the
        # first sample.
        if suffix in group[1]:
            if mtype == 'counter':
                group[1][suffix] += value
        else:
            group[1][suffix] = value

    def text(self) -> str:
        lines: List[str] = []
        for family, (mtype, samples) in self._families.items():
            lines.append(f'# TYPE {family} {mtype}')
            lines.extend(f'{family}{suffix} {value}'
                         for suffix, value in samples.items())
        return '\n'.join(lines) + '\n'


def _emit_scalars(doc: _Doc, metrics: Mapping[str, Any],
                  exposition: Dict[str, Tuple[str, str]]) -> None:
    for key, (family, mtype) in exposition.items():
        doc.add(family, mtype, metrics.get(key))


def render_replica(metrics: Dict[str, Any]) -> str:
    """An inference replica's ``/metrics`` JSON as Prometheus text."""
    doc = _Doc()
    fams = label_families()
    _emit_scalars(doc, metrics, replica_exposition())
    integ = metrics.get('integrity')
    if isinstance(integ, str):
        # State-set encoding (the breaker-state rule): one series per
        # state, value 1 for the active one — a string never survives
        # _Doc.add as a scalar.
        fam, t = fams['engine_integrity']
        doc.add(fam, t, 1, {'state': integ})
    for tenant, row in sorted(
            (metrics.get('tenants') or {}).items()):
        if not isinstance(row, dict):
            continue
        labels = {'tenant': tenant}
        fam, t = fams['engine_tenant_queue_depth']
        doc.add(fam, t, row.get('queue_depth'), labels)
        fam, t = fams['engine_tenant_decode_tokens']
        doc.add(fam, t, row.get('decode_tokens'), labels)
        fam, t = fams['engine_tenant_requests_shed']
        doc.add(fam, t, row.get('requests_shed'), labels)
        fam, t = fams['engine_tenant_ttft_p99']
        doc.add(fam, t, row.get('ttft_p99_s'), labels)
    return doc.text()
