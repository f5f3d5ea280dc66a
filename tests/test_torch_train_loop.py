"""``TrainSupervisor`` and the train launcher on the CPU: a run with an
injected failure restarts from the latest checkpoint and resumes with the
uninterrupted run's losses, as the reference's
``tests/test_substrate.py::test_train_restart_resumes_identically`` holds
its own, also when the latest save is still in flight at the failure;
stragglers are counted; a mesh without its shardings (or the other way
round) raises; the launcher trains, resumes, and raises without a card
unless asked for the CPU, and for a mesh that the card cannot hold. The
mesh runs themselves are in ``test_torch_distributed.py``."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpointing.checkpoint import latest_step, restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_state  # noqa: E402
from repro_torch.runtime.train_loop import FailureInjector, TrainReport, TrainSupervisor  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

SMOKE = ShapeSpec("smoke", 32, 2, "train")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_train_restart_resumes_identically(tmp_path, arch):
    cfg = get_config(arch).reduced()
    base = TrainSupervisor(cfg, SMOKE, str(tmp_path / "a"), ckpt_every=4, device="cpu").run(total_steps=8)
    assert (base.steps_run, base.final_step, base.restarts, base.checkpoints) == (8, 8, 0, 2)
    rep = TrainSupervisor(cfg, SMOKE, str(tmp_path / "b"), ckpt_every=4, device="cpu").run(
        total_steps=8, injector=FailureInjector(fail_at=[6]))
    assert rep.restarts == 1 and rep.final_step == 8
    # steps 0-5, the failure at 6, then 4-7 again from the step-4 checkpoint
    assert len(rep.losses) == 10 and rep.steps_run == 10
    assert rep.losses[:6] == base.losses[:6]
    assert rep.losses[6:] == base.losses[4:]  # the same bits after the restart
    assert np.isfinite(base.losses).all()
    assert latest_step(str(tmp_path / "b")) == 8


def test_a_save_in_flight_at_a_failure_lands_before_the_restart(tmp_path, monkeypatch):
    """The step-2 save is still being written when step 3 fails (a slow
    disk, or a fast card): the restart waits for it and resumes from step 2
    instead of finding no checkpoint and starting over."""
    from repro_torch.checkpointing import checkpoint

    inner = checkpoint.save

    def slow_save(*args, **kw):
        time.sleep(0.5)
        return inner(*args, **kw)

    monkeypatch.setattr(checkpoint, "save", slow_save)
    cfg = get_config("qwen3-1.7b").reduced()
    rep = TrainSupervisor(cfg, SMOKE, str(tmp_path), ckpt_every=2, device="cpu").run(
        total_steps=4, injector=FailureInjector(fail_at=[3]))
    assert rep.restarts == 1 and rep.final_step == 4
    # steps 0-2, the failure at 3, then 2-3 again from the step-2 checkpoint
    assert len(rep.losses) == 5 and rep.losses[3] == rep.losses[2]
    assert latest_step(str(tmp_path)) == 4


def test_restarts_stop_after_max_and_other_errors_pass(tmp_path):
    cfg = get_config("qwen3-1.7b").reduced()
    sup = TrainSupervisor(cfg, SMOKE, str(tmp_path), ckpt_every=1, device="cpu")
    with pytest.raises(RuntimeError, match="injected node failure"):
        sup.run(total_steps=3, injector=FailureInjector(fail_at=[0, 1, 2]), max_restarts=2)

    class Broken(FailureInjector):
        def maybe_fail(self, step):
            raise RuntimeError("disk on fire")

    with pytest.raises(RuntimeError, match="disk on fire"):
        sup.run(total_steps=3, injector=Broken())


def test_stragglers_are_counted(tmp_path, monkeypatch):
    cfg = get_config("qwen3-1.7b").reduced()
    sup = TrainSupervisor(cfg, SMOKE, str(tmp_path), ckpt_every=100, device="cpu")
    ticks = iter([0.0, 1.0] * 6 + [10.0, 20.0] + [20.0, 21.0] * 2)  # step 7 takes 10x the median
    monkeypatch.setattr("repro_torch.runtime.train_loop.time.perf_counter", lambda: next(ticks))
    report = sup.run(total_steps=9)
    assert report.straggler_steps == 1 and report.checkpoints == 1


def test_the_checkpoint_holds_the_final_state(tmp_path):
    cfg = get_config("qwen3-1.7b").reduced()
    TrainSupervisor(cfg, SMOKE, str(tmp_path), ckpt_every=2, seed=3, device="cpu").run(total_steps=3)
    target = make_train_state(cfg, torch.Generator().manual_seed(99))
    state = restore(str(tmp_path), 3, target)
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3
    assert sorted(p for p, _ in flatten(state))[0] == "opt/count"


def test_meshes_and_shardings_raise(tmp_path):
    cfg = get_config("qwen3-1.7b").reduced()
    for kw in ({"mesh": object()}, {"shardings": {}}):
        with pytest.raises(ValueError, match="together"):
            TrainSupervisor(cfg, SMOKE, str(tmp_path), device="cpu", **kw)


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "3", "--seq-len", "16", "--global-batch", "2",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    report = train_cli.main(argv)
    assert isinstance(report, TrainReport) and report.final_step == 3 and report.checkpoints == 2
    assert "final_step=3" in capsys.readouterr().out
    again = train_cli.main(argv)  # resumes at step 3: nothing left to run
    assert again.steps_run == 0 and "already at --steps" in capsys.readouterr().out
    more = train_cli.main(argv[:4] + ["5"] + argv[5:])
    assert more.steps_run == 2 and more.final_step == 5


def test_launcher_needs_a_card_or_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="needs --mesh"):
        train_cli.main(["--reduced", "--device", "cpu", "--devices", "8"])
    with pytest.raises(SystemExit, match="needs 8 ranks"):
        train_cli.main(["--reduced", "--device", "cpu", "--devices", "4", "--mesh", "2x4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="one card"):
        train_cli.main(["--reduced", "--mesh", "2x4"])
