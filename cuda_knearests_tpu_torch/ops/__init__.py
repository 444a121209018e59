"""Grid build, planning, packing, the CUDA kernel's wrapper and the solve."""
