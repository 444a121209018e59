"""Observability: the span tracer (:mod:`spans`) and the metrics registry
(:mod:`metrics`).  Pure Python; importing it touches no device."""
