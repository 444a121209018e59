"""Host-boundary accounting of the solve."""
