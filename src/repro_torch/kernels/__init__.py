"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``), each
with a ctypes wrapper in ``ops.py`` and its plain PyTorch version in ``ref.py``."""


def takes_plain(*tensors) -> bool:
    """Whether a wrapper takes its plain version for these tensors: all on
    the CPU, or all on ``meta`` (shapes only, as the dry-run builds them:
    nothing runs there, so no kernel is stood in for). A call that takes it
    counts no launch; any other call launches its kernel or raises."""
    kinds = {t.device.type for t in tensors}
    return kinds == {"cpu"} or kinds == {"meta"}
