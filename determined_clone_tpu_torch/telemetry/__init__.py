"""Telemetry: the analytic FLOP counts (training and serving) and MFU
against the H100's peak, the metrics registry with its Prometheus text,
and the span tracer."""
