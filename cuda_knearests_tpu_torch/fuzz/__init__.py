"""Differential checking of the port's answers (numpy only)."""
