"""Errors and device selection shared by the engine's modules, the stats
report and the phase timers."""

from . import memory, stats, stopwatch
from .stopwatch import Stopwatch, timed

__all__ = ["memory", "stats", "stopwatch", "Stopwatch", "timed"]
