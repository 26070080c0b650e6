"""Measurement helpers of the port (port of `lanczos_tpu/utils`)."""
