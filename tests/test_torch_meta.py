"""The kernel wrappers on the meta device, where the dry-run builds its
cells: every wrapper takes its plain version for tensors all on ``meta``
(shapes only, nothing runs, so no kernel is stood in for) and counts no
launch; inputs on two devices still raise, and the CUDA path raises for
anything that is not on the card: there is no fallback. The model's init
builds the same tree on ``meta`` from ``SHAPES_ONLY``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.launch.steps import abstract_train_state, make_train_state  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

META = torch.device("meta")
BF16 = torch.bfloat16


def _m(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device=META)


def _counts():
    return (mm_ops.stream_matmul.launches, mm_ops.stream_matmul.batched_launches,
            mm_ops.stream_matmul_int8.launches, fa_ops.flash_attention.launches,
            fa_ops.flash_attention.bwd_launches, pa_ops.paged_attention.launches)


CALLS = {
    "stream_matmul": (lambda: mm_ops.stream_matmul(_m(16, 64), _m(64, 32)), (16, 32)),
    "stream_matmul nk": (lambda: mm_ops.stream_matmul(_m(16, 64), _m(32, 64), w_layout="nk"), (16, 32)),
    "stream_matmul batched": (lambda: mm_ops.stream_matmul(_m(4, 8, 64), _m(4, 64, 32),
                                                           rows=_m(4, dtype=torch.int32)), (4, 8, 32)),
    "stream_matmul_int8": (lambda: mm_ops.stream_matmul_int8(_m(4, 128), _m(128, 32, dtype=torch.int8),
                                                             _m(2, 32, dtype=torch.float32), 64), (4, 32)),
    "flash_attention": (lambda: fa_ops.flash_attention(_m(2, 16, 4, 32), _m(2, 16, 2, 32), _m(2, 16, 2, 32)),
                        (2, 16, 4, 32)),
    "flash_attention_backward": (lambda: fa_ops.flash_attention_backward(
        *(_m(2, 16, 4, 32), _m(2, 16, 2, 32), _m(2, 16, 2, 32), _m(2, 16, 4, 32), _m(2, 16, 4, 32)))[1],
        (2, 16, 2, 32)),
    "paged_attention": (lambda: pa_ops.paged_attention(_m(2, 4, 32), _m(8, 16, 2, 32), _m(8, 16, 2, 32),
                                                       _m(2, 4, dtype=torch.int32), _m(2, dtype=torch.int32)),
                        (2, 4, 32)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrappers_take_the_plain_version_on_meta(name):
    call, shape = CALLS[name]
    before = _counts()
    out = call()
    assert out.device.type == "meta" and tuple(out.shape) == shape
    assert _counts() == before


def test_two_devices_and_the_cuda_path_still_raise():
    x_cpu = torch.zeros(16, 64, dtype=BF16)
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x_cpu, _m(64, 32))  # the CUDA path: not on the card
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(_m(4, 8, 64), torch.zeros(4, 64, 32, dtype=BF16))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(_m(2, 16, 4, 32), _m(2, 16, 2, 32), torch.zeros(2, 16, 2, 32, dtype=BF16))
    with pytest.raises(ValueError):
        pa_ops.paged_attention(_m(2, 4, 32), _m(8, 16, 2, 32), _m(8, 16, 2, 32),
                               torch.zeros(2, 4, dtype=torch.int32), _m(2, dtype=torch.int32))
    with pytest.raises(ValueError):  # all on meta, but called past the wrapper: the kernel's own path
        mm_ops._stream_matmul_2d(_m(16, 64), _m(64, 32), BF16, "kn")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shapes_only_init_is_the_real_tree(arch):
    cfg = get_config(arch).reduced()
    real = dict(flatten(make_train_state(cfg, torch.Generator().manual_seed(0))))
    meta = dict(flatten(abstract_train_state(cfg)))
    assert list(meta) == list(real)
    for path, t in meta.items():
        assert t.device.type == "meta" and t.shape == real[path].shape and t.dtype == real[path].dtype, path
