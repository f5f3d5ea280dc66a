"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
(nor msgpack and ml_dtypes, which the reference's checkpoints and bf16
arrays use), and its entry points do not fall back to the CPU when there is
no card."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|msgpack|ml_dtypes)(\.|\s|$)", re.M)

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "msgpack", "ml_dtypes"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for want in ("repro_torch.launch.specs", "repro_torch.launch.train", "repro_torch.optim.optimizers",
             "repro_torch.optim.schedules", "repro_torch.data.pipeline", "repro_torch.runtime.compression",
             "repro_torch.runtime.train_loop", "repro_torch.checkpointing.checkpoint",
             "repro_torch.checkpointing.manifest", "repro_torch.tree", "repro_torch.launch.mesh",
             "repro_torch.launch.dryrun", "repro_torch.sharding.act", "repro_torch.sharding.specs",
             "repro_torch.roofline.costs", "repro_torch.core.workloads", "repro_torch.core.demand_paging",
             "repro_torch.core.simulator", "repro_torch.core.invariants", "repro_torch.control.deadline",
             "repro_torch.cluster.aggregate", "repro_torch.serving", "repro_torch.serving.traces",
             "repro_torch.serving.lifecycle", "repro_torch.serving.admission", "repro_torch.serving.engine",
             "repro_torch.telemetry", "repro_torch.telemetry.hub", "repro_torch.telemetry.metrics",
             "repro_torch.telemetry.audit", "repro_torch.telemetry.export", "repro_torch.cluster",
             "repro_torch.cluster.topology", "repro_torch.cluster.placement", "repro_torch.cluster.transfer_plan",
             "repro_torch.cluster.migration", "repro_torch.cluster.prefetch", "repro_torch.cluster.faults",
             "repro_torch.cluster.engine", "repro_torch.control", "repro_torch.control.journal",
             "repro_torch.control.lifecycle", "repro_torch.control.plane"):
    assert want in names, (want, names)
import chip_smoke  # noqa: F401  (the module does nothing on import)
sys.path.insert(0, "examples")
import port_multitask_oversubscription  # noqa: F401  (runs only as a script)
import port_quickstart  # noqa: F401
import port_train_lm  # noqa: F401
import port_serve_trace  # noqa: F401
import port_cluster_serve  # noqa: F401
sys.path.insert(0, "scripts")
import port_msctl  # noqa: F401  (runs only as a script)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print(len(names))
"""


def _port_modules():
    import repro_torch

    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_every_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules()) > 20


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"] + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("port_*.py"))
    + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("port_*.py")),
)
def test_source_imports_no_jax_or_reference(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), f"{path}: {FORBIDDEN.search(text).group(0)!r}"


def test_port_examples_exist():
    for name in ("port_multitask_oversubscription", "port_quickstart", "port_train_lm", "port_serve_trace",
                 "port_cluster_serve"):
        assert (ROOT / "examples" / f"{name}.py").is_file(), name
    assert (ROOT / "scripts" / "port_msctl.py").is_file()


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.core.runtime import LiveModelTask
    from repro_torch.launch.mesh import init_ranks, make_mesh, make_production_mesh
    from repro_torch.runtime.serve_loop import MultiModelServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveModelTask(0, "qwen3-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiModelServer(["qwen3-1.7b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_ranks(0, 1, "unused-store")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
