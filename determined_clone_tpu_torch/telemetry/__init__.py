"""Telemetry: the analytic FLOP count and MFU against the H100's peak."""
