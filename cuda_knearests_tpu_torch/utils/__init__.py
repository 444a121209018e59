"""Errors and device selection shared by the engine's modules."""
