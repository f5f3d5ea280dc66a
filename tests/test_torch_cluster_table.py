"""``chip_smoke.py``'s phase 11 gates the card's host against
``CLUSTER_REFERENCE``; here that table is held to the JAX package's own run
of the same calls: ``examples/cluster_serve.py --gpus 4 --migrate`` (its
``simulate_cluster`` calls recorded) and the crash demo fleet of
``scripts/msctl.py``, compared exactly (the phase allows floats 1e-9 of
another host's libm). The port's side of these runs is the card's phase 11;
the port's cluster is held to the reference on smaller runs in the other
``test_torch_cluster*`` files."""
import importlib.util
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_cluster_table_is_the_reference(monkeypatch, capsys):
    chip_smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_cluster_table")
    example = _load(ROOT / "examples" / "cluster_serve.py", "reference_cluster_serve")
    reports = {}
    simulate = example.simulate_cluster

    def record(*args, **kw):
        rep = simulate(*args, **kw)
        reports[rep.placement] = rep
        return rep

    monkeypatch.setattr(example, "simulate_cluster", record)
    monkeypatch.setattr(sys, "argv", ["cluster_serve.py", "--gpus", str(chip_smoke.CLUSTER_GPUS), "--migrate"])
    example.main()
    assert capsys.readouterr().out.startswith("trace: 56 requests")
    msctl = _load(ROOT / "scripts" / "msctl.py", "reference_msctl")
    reports["demo"], control = msctl._run_demo_fleet(True)
    got = {name: chip_smoke.cluster_scoreboard(rep) for name, rep in reports.items()}
    got["demo"].update(journal=len(control.journal), lifecycle=chip_smoke.lifecycle_summary(control, msctl._ORDER))
    assert sorted(got) == sorted(chip_smoke.CLUSTER_REFERENCE)
    for name, want in chip_smoke.CLUSTER_REFERENCE.items():
        assert got[name] == want, name
        assert repr(got[name]) == repr(want), name
        assert chip_smoke.cluster_mismatches(got[name], want) == []
    assert set(chip_smoke.CLUSTER_TRACED) <= set(got)


def test_cluster_gate_flags_a_difference():
    """The phase's comparison: floats within CLUSTER_RTOL pass, anything
    else that differs (a type, a list, a missing key) is reported."""
    chip_smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_cluster_gate")
    want = dict(chip_smoke.CLUSTER_REFERENCE["msched"])
    near = dict(want, ttft_p99_us=want["ttft_p99_us"] * (1 + 1e-12))
    assert chip_smoke.cluster_mismatches(near, want) == []
    for bad in (dict(want, ttft_p99_us=want["ttft_p99_us"] * (1 + 1e-6)), dict(want, n_finished=55),
                dict(want, n_finished=56.0), dict(want, gpu_placed=list(reversed(want["gpu_placed"]))),
                {k: v for k, v in want.items() if k != "migrations"}, dict(want, extra=1)):
        assert len(chip_smoke.cluster_mismatches(bad, want)) == 1
