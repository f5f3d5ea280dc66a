"""The port's examples on the CPU: ``examples/port_multitask_oversubscription.py``
(the paper's headline scenario) gives the stats of the JAX package's
``LiveRuntime`` on the same archs, seeds and budget exactly: MSched's
decisions read the weights' shapes, never their values. The training
examples, ``examples/port_quickstart.py`` and ``examples/port_train_lm.py``,
run as scripts with fewer steps: the loss falls, the model is the
reference's, and ``--kill-at`` gives the uninterrupted run's loss bits. Each
script runs in a subprocess of one thread."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.runtime import LiveModelTask as RefTask  # noqa: E402
from repro.core.runtime import LiveRuntime as RefRuntime  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "port_multitask_oversubscription.py"
ONE_THREAD = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _example(name="port_multitask_oversubscription"):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script(*argv, timeout=300):
    out = subprocess.run([sys.executable, *argv], env=ONE_THREAD, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


@pytest.fixture(scope="module")
def reference_stats():
    """``examples/multitask_oversubscription.py``'s run on the JAX package."""
    archs = _example().ARCHS
    tasks = [RefTask(i, a, seed=i) for i, a in enumerate(archs)]
    budget = int(sum(t.footprint_bytes() for t in tasks) / 2.0)
    return RefRuntime(tasks, budget, steps_per_slice=4).run(total_slices=9)


def _printed(stats):
    """The lines of the example's report that MSched's decisions set."""
    return [
        f"steps per task: {stats.steps}",
        f"proactively migrated in : {stats.migrated_in_bytes/2**20:8.1f} MiB",
        f"evicted to host         : {stats.migrated_out_bytes/2**20:8.1f} MiB",
        f"demand faults (F- path) : {stats.demand_faults}",
    ]


def test_example_stats_equal_reference(reference_stats):
    stats = _example().run("cpu")
    assert stats.steps == reference_stats.steps == {0: 12, 1: 12, 2: 12}
    assert stats.migrated_in_bytes == reference_stats.migrated_in_bytes > 0
    assert stats.migrated_out_bytes == reference_stats.migrated_out_bytes
    assert stats.demand_faults == reference_stats.demand_faults


def test_example_runs_as_a_script_on_the_cpu(reference_stats):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(EXAMPLE), "--device", "cpu"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "(200% oversubscription) on cpu" in lines[0]
    for line in _printed(reference_stats):
        assert line in lines, (line, lines)


def test_example_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main([])


def test_quickstart_runs_as_a_script_on_the_cpu():
    """12 of the 30 steps: the loss falls from about ln(512); the reduced
    model has the reference's parameter count."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.launch.steps import make_train_state as ref_state

    lines = _script(str(ROOT / "examples" / "port_quickstart.py"), "--device", "cpu", "--steps", "12")
    n_ref = sum(p.size for p in jax.tree.leaves(ref_state(ref_config("qwen3-1.7b").reduced(),
                                                          jax.random.PRNGKey(0))["params"]))
    assert lines[0] == f"arch=qwen3-1.7b (reduced) params={n_ref:,} on cpu", lines[0]
    losses = [float(line.split()[3]) for line in lines if line.startswith("step ")]
    assert len(losses) == 4 and abs(losses[0] - 6.24) < 0.6 and losses[-1] < losses[0] - 0.5, losses


def test_train_lm_config_is_the_reference():
    spec = importlib.util.spec_from_file_location("train_lm", ROOT / "examples" / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    got, want = _example("port_train_lm").build_cfg(), ref.build_cfg()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_train_lm_runs_as_a_script_and_restarts_with_the_same_bits(tmp_path):
    """The reduced config for 40 steps, checkpoints every 10: the loss falls
    (the script raises otherwise); with a failure injected at step 25 the run
    restarts from step 20 and gives the uninterrupted losses' bits."""
    lines = _script(str(ROOT / "examples" / "port_train_lm.py"), "--device", "cpu", "--reduced", "--steps", "40",
                    "--ckpt-every", "10", "--ckpt-dir", str(tmp_path / "script"))
    assert lines[1].startswith("steps=40 restarts=0 checkpoints=4"), lines
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT / "examples")!r})
import port_train_lm
runs = [port_train_lm.run(40, kill, {str(tmp_path)!r} + f"/{{kill}}", 10, "cpu", True)[0] for kill in (None, 25)]
print(json.dumps([{{"losses": r.losses, "restarts": r.restarts, "final": r.final_step}} for r in runs]))
"""
    base, killed = json.loads(_script("-c", code)[-1])
    assert killed["restarts"] == 1 and killed["final"] == base["final"] == 40
    assert len(killed["losses"]) == 25 + 20
    assert killed["losses"][25:] == base["losses"][20:]
    assert base["losses"][-1] < base["losses"][0]


def test_training_examples_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("port_quickstart").main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("port_train_lm").main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
