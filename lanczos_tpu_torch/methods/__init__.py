"""Lanczos recurrences, the expm action and the FDTD oracle."""
