"""Operators and right-hand sides (the Maxwell fixture)."""
