"""The port's cluster entry points against the JAX package's, run as
scripts: ``examples/port_cluster_serve.py`` prints ``examples/cluster_serve.py``'s
lines for the same arguments, and ``scripts/port_msctl.py`` prints
``scripts/msctl.py``'s for ``demo --crash``, ``journal``, ``status``
(``--task`` too) and ``metrics`` (``--demo``, ``--prom``), each CLI reading
the other's journal dumps and metrics reports. The two scripts of a pair run
at the same time."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def pair(ref, port, cwd):
    """Runs the reference's and the port's command side by side; their
    (exit code, stdout, stderr)."""
    procs = [subprocess.Popen([sys.executable, *cmd], env=ENV, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in (ref, port)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        out.append((p.returncode, stdout, stderr))
    return out


@pytest.mark.parametrize("args", [[], ["--gpus", "3", "--seed", "1", "--duration", "2.0", "--migrate"]],
                         ids=["defaults", "3-gpus-migrate"])
def test_cluster_serve_prints_the_reference_lines(args, tmp_path):
    ref, port = pair([str(ROOT / "examples" / "cluster_serve.py"), *args],
                     [str(ROOT / "examples" / "port_cluster_serve.py"), *args], tmp_path)
    assert port[0] == ref[0] == 0, port[2]
    assert port[1] == ref[1]
    lines = port[1].splitlines()
    assert len(lines) == 4 and lines[0].startswith("trace: ")
    assert ("migrations=" in lines[-1]) == ("--migrate" in args)


@pytest.fixture(scope="module")
def msctl_runs(tmp_path_factory):
    """Both CLIs' ``demo --crash`` and ``metrics --demo --crash``, each
    writing its journal dump or report into one directory."""
    d = tmp_path_factory.mktemp("msctl")
    scripts = {"ref": str(ROOT / "scripts" / "msctl.py"), "port": str(ROOT / "scripts" / "port_msctl.py")}
    demo = pair([scripts["ref"], "demo", "--crash", "--journal-out", "ref.json"],
                [scripts["port"], "demo", "--crash", "--journal-out", "port.json"], d)
    metrics = pair([scripts["ref"], "metrics", "--demo", "--crash", "--out", "ref_report.json"],
                   [scripts["port"], "metrics", "--demo", "--crash", "--out", "port_report.json"], d)
    return d, scripts, demo, metrics


def test_demo_and_metrics_print_the_reference_lines(msctl_runs):
    d, _, demo, metrics = msctl_runs
    for (ref, port), names in ((demo, ("ref.json", "port.json")), (metrics, ("ref_report.json", "port_report.json"))):
        assert ref[0] == port[0] == 0, port[2]
        assert port[1].replace(names[1], "X") == ref[1].replace(names[0], "X")
        assert (d / names[0]).read_bytes() == (d / names[1]).read_bytes()
    assert demo[1][1].splitlines()[:2] == [
        "demo run: 16 requests, 15 finished, 0 lost, 1 coordinator crash(es), 1 journal replay(s)",
        "lifecycle: FINISHED=15, CANCELLED=1"]
    assert len(json.loads((d / "port.json").read_text())) == 74


@pytest.mark.parametrize("cmd", [["journal", "{}"], ["status", "{}"], ["status", "{}", "--task", "3"],
                                 ["status", "{}", "--task", "999"], ["metrics", "{}"], ["metrics", "{}", "--prom"]],
                         ids=["journal", "status", "status-task", "status-unknown", "metrics", "prom"])
def test_offline_commands_read_each_others_files(msctl_runs, cmd):
    """Each CLI reads the other's dump (or report) and prints what the
    reference prints for its own."""
    d, scripts, _, _ = msctl_runs
    stem = "{}_report.json" if cmd[0] == "metrics" else "{}.json"
    own = pair([scripts["ref"], *(a.format(stem.format("ref")) for a in cmd)],
               [scripts["port"], *(a.format(stem.format("port")) for a in cmd)], d)
    crossed = pair([scripts["ref"], *(a.format(stem.format("port")) for a in cmd)],
                   [scripts["port"], *(a.format(stem.format("ref")) for a in cmd)], d)
    want = own[0]
    assert want[1], want[2]
    for got in (own[1], *crossed):
        assert got[:2] == want[:2], got[2]
