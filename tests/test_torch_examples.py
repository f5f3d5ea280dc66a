"""The port's examples on the CPU: ``examples/port_multitask_oversubscription.py``
(the paper's headline scenario) gives the stats of the JAX package's
``LiveRuntime`` on the same archs, seeds and budget exactly: MSched's
decisions read the weights' shapes, never their values."""
import importlib.util
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


def _example():
    spec = importlib.util.spec_from_file_location("port_multitask_oversubscription", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
