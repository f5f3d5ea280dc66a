"""Checkpoints in the JAX package's on-disk format: the port's manifest coder
gives ``msgpack.packb``'s bytes; the port and the reference write the same
files for the same train state (every ``.npy`` and the manifest, byte for
byte, bf16 included); each restores what the other saved, bit for bit; and
retention, the async saver and the atomic overwrite behave as the
reference's."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.steps import make_train_state as ref_make_train_state  # noqa: E402
from repro_torch.checkpointing import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpointing import manifest  # noqa: E402
from repro_torch.models.convert import to_numpy, train_state_from_reference  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402


def ref_state(arch="qwen3-1.7b", seed=0):
    """A reduced train state of the reference as numpy (bf16 params, f32
    moments, int32 count and step)."""
    return jax.tree.map(np.asarray, ref_make_train_state(ref_get_config(arch).reduced(), jax.random.PRNGKey(seed)))


def bump(state):
    """The same tree with other values in every leaf."""
    return tree_map(lambda t: (t + 1).to(t.dtype), state)


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -2**15 - 1,
    -2**31 - 1, -2**63, "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "b" * 70000, "naïve", [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    None, True, False, 1.5, -0.0, b"", b"xy" * 200, (1, "two", [3.0]),
    {"step": 12345678, "leaves": [{"path": "opt/m/layers/attn/wq", "file": "leaf_00007.npy", "dtype": "bfloat16",
                                   "shape": [28, 2048, 151936]}] * 40},
])
def test_coder_bytes_equal_msgpack(obj):
    data = manifest.packb(obj)
    assert data == msgpack.packb(obj)
    assert manifest.unpackb(data) == msgpack.unpackb(data)


def test_the_port_writes_the_reference_s_files(tmp_path):
    state = ref_state()
    ref_dir = ref_ckpt.save(str(tmp_path / "ref"), 7, state)
    our_dir = ckpt.save(str(tmp_path / "port"), 7, train_state_from_reference(state))
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(our_dir)) and "manifest.msgpack" in names and len(names) > 10
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as a, open(os.path.join(our_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(our_dir, "manifest.msgpack"), "rb") as f:
        data = f.read()
    meta = msgpack.unpackb(data)
    assert data == msgpack.packb(meta) == manifest.packb(manifest.unpackb(data))
    paths = [e["path"] for e in meta["leaves"]]
    assert paths[0] == "opt/count" and paths[-1] == "step" and "params/head/embed" in paths
    assert {e["dtype"] for e in meta["leaves"]} == {"bfloat16", "float32", "int32"}


def test_the_reference_restores_what_the_port_saved(tmp_path):
    state = train_state_from_reference(ref_state(seed=1))
    ckpt.save(str(tmp_path), 3, state)
    target = jax.tree.map(jnp.asarray, ref_state(seed=2))
    restored = ref_ckpt.restore(str(tmp_path), 3, target)
    ours = dict(flatten(state))
    for path, leaf in flatten(jax.tree.map(np.asarray, restored)):
        want = to_numpy(ours[path], bf16_dtype=jnp.bfloat16)
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, path
        assert leaf.tobytes() == want.tobytes(), path


def test_the_port_restores_what_the_reference_saved(tmp_path):
    state = ref_state(seed=3)
    ref_ckpt.save(str(tmp_path), 5, state)
    target = train_state_from_reference(ref_state(seed=4))
    restored = ckpt.restore(str(tmp_path), 5, target)
    assert restored["params"]["head"]["embed"] is target["params"]["head"]["embed"]  # filled in place
    want = dict(flatten(state))
    for path, t in flatten(restored):
        got = to_numpy(t, bf16_dtype=jnp.bfloat16)
        assert got.dtype == want[path].dtype and got.tobytes() == np.asarray(want[path]).tobytes(), path


def test_restore_raises_on_another_shape(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="restore w"):
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(4, 3)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"v": torch.zeros(3, 4)})


def test_retention_keeps_the_newest_three(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step * 10, tree)
    os.makedirs(tmp_path / "step_00000090.tmp")  # a save that never finished
    assert sorted(os.listdir(tmp_path)) == ["step_00000030", "step_00000040", "step_00000050", "step_00000090.tmp"]
    assert ckpt.latest_step(str(tmp_path)) == ref_ckpt.latest_step(str(tmp_path)) == 50


def test_atomic_overwrite_of_a_step(tmp_path):
    first = {"w": torch.ones(4, dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path), 2, first)
    os.makedirs(tmp_path / "step_00000002.tmp", exist_ok=True)  # left by a crash during the next save
    ckpt.save(str(tmp_path), 2, bump(first))
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    out = ckpt.restore(str(tmp_path), 2, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert torch.equal(out["w"], bump(first)["w"])


def test_async_saver_copies_before_the_next_step(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    state = train_state_from_reference(ref_state(seed=5))
    saved = tree_map(lambda t: t.clone(), state)
    saver.save_async(1, state)
    for _, t in flatten(state):  # the step after the save updates in place
        t.add_(1)
    saver.save_async(2, state)
    saver.save_async(3, state)
    saver.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    saver2 = ckpt.AsyncCheckpointer(str(tmp_path / "a"))
    saver2.save_async(1, saved)
    saver2.wait()
    out = ckpt.restore(str(tmp_path / "a"), 1, bump(saved))
    for (path, a), (_, b) in zip(flatten(out), flatten(saved)):
        assert torch.equal(a, b), path


def test_async_saver_raises_the_worker_s_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(str(blocker / "ckpt"))
    saver.save_async(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # the error is raised once


def _host_manifest(n=3, seed=0):
    """``cluster/migration.pack_working_set``'s five leaves: int64 scalars
    and run bounds, as numpy arrays."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, 1 << 40, n)).astype(np.int64)
    return {"task_id": np.int64(7), "completed": np.int64(94), "page_size": np.int64(1 << 20),
            "resident_starts": starts, "resident_stops": starts + rng.integers(1, 1 << 20, n).astype(np.int64)}


def _host_target(n=3):
    return {"task_id": np.zeros((), np.int64), "completed": np.zeros((), np.int64),
            "page_size": np.zeros((), np.int64), "resident_starts": np.zeros((n,), np.int64),
            "resident_stops": np.zeros((n,), np.int64)}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("reader", ["port", "reference"])
def test_restore_into_a_numpy_host_target(tmp_path, writer, reader):
    """A numpy target stays on the host: each leaf comes back as a new numpy
    array of the checkpoint's dtype and shape (int64 stays int64; the target
    is not written), as the reference restores one, in both directions
    between the packages."""
    tree = _host_manifest()
    {"port": ckpt, "reference": ref_ckpt}[writer].save(str(tmp_path), 4, tree, keep=4)
    target = _host_target()
    out = {"port": ckpt, "reference": ref_ckpt}[reader].restore(str(tmp_path), 4, target)
    assert sorted(out) == sorted(tree)
    for key, want in tree.items():
        got = out[key]
        assert isinstance(got, np.ndarray) and got.dtype == np.int64 and got.shape == np.shape(want), key
        assert got.tolist() == np.asarray(want).tolist(), key
        assert not np.any(target[key]), key


def test_restore_keeps_a_numpy_leaf_beside_tensors(tmp_path):
    """A mixed tree: the tensor is filled in place on its device, the numpy
    leaf comes back as a new array, the returned tree holds both."""
    ckpt.save(str(tmp_path), 1, {"w": torch.arange(6, dtype=torch.float32), "n": np.arange(3, dtype=np.int64) + 40})
    target = {"w": torch.zeros(6), "n": np.zeros(3, np.int64)}
    out = ckpt.restore(str(tmp_path), 1, target)
    assert out["w"] is target["w"] and torch.equal(target["w"], torch.arange(6, dtype=torch.float32))
    assert out["n"] is not target["n"] and out["n"].tolist() == [40, 41, 42] and out["n"].dtype == np.int64


def test_restore_into_numpy_raises_on_another_shape(tmp_path):
    """A numpy leaf of another shape raises, and so does a bf16 leaf (stored
    as a uint16 view; numpy has no bf16 to give it back as)."""
    ckpt.save(str(tmp_path), 1, _host_manifest(n=3))
    with pytest.raises(ValueError, match="restore resident_starts"):
        ckpt.restore(str(tmp_path), 1, _host_target(n=2))
    ckpt.save(str(tmp_path), 2, {"w": torch.ones(4, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="restore w: checkpoint .* bfloat16"):
        ckpt.restore(str(tmp_path), 2, {"w": np.zeros(4, np.uint16)})
