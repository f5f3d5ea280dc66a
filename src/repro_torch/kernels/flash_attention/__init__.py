"""Online-softmax attention: CUDA kernel, wrapper and plain version."""
