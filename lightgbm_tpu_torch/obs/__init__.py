"""Observability: the metrics registry serving exports on /metrics
(obs/metrics.py). The JAX package's run recorder, anomaly sentinels,
tracing and manifests are not ported (ROADMAP A.11)."""
