"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``), each
with a ctypes wrapper in ``ops.py`` and its plain PyTorch version in ``ref.py``."""
from repro_torch.roofline import memory


def takes_plain(*tensors) -> bool:
    """Whether a wrapper takes its plain version for these tensors: all on
    the CPU, or all on ``meta`` (shapes only, as the dry-run builds them:
    nothing runs there, so no kernel is stood in for) outside the dry-run's
    memory pass. A call that takes it counts no launch; any other call
    launches its kernel or raises, or, on meta under the memory pass
    (``roofline.memory.count(..., card=True)``), allocates what its launch
    would and launches nothing."""
    kinds = {t.device.type for t in tensors}
    return kinds == {"cpu"} or (kinds == {"meta"} and not memory.card_shapes())


def on_card(t) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a meta tensor
    under the dry-run's memory pass."""
    return t.is_cuda or (t.is_meta and memory.card_shapes())
