"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``), each
with a ctypes wrapper in ``ops.py`` and its plain PyTorch version in ``ref.py``."""
