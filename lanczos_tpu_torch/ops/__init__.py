"""Operators, precision policy, small dense algebra and the kernels."""
