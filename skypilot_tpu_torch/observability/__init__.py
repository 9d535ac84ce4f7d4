"""The replica's observability: the flight recorder (``stepline``), the
span store its anomaly dumps land in (``store``), their Perfetto export
(``render``) and the Prometheus text of ``/metrics`` (``prometheus``).
Host-side copies of the JAX package's modules of the same names."""
