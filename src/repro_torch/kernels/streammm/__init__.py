"""Weight-streaming matmul: CUDA kernel, wrapper and plain version."""
