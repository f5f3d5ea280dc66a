"""End-to-end training run on the PyTorch port: a ~100M-parameter LM for
a few hundred steps with the training substrate (deterministic data
pipeline, WSD schedule, async checkpoints, the fault-tolerant supervisor and
restart continuation), the counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/port_train_lm.py [--steps 200] [--kill-at 120] \\
        [--ckpt-dir DIR] [--ckpt-every 40] [--device cpu] [--reduced]

``--kill-at`` injects a node failure mid-run: the run resumes from the last
checkpoint and finishes, and the loss curve is that of an uninterrupted run.
Checkpoints go to ``--ckpt-dir`` (by default ``build/train_lm`` under the
checkout, git-ignored); a run resumes from the latest one there.
``--reduced`` trains the same family at ``ModelConfig.reduced()``'s size, for
a run on the CPU.
"""
import argparse
import dataclasses
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.runtime.train_loop import FailureInjector, TrainSupervisor

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeSpec("train", seq_len=128, global_batch=4, kind="train")


def build_cfg(reduced: bool = False):
    # ~100M-param llama-style config (scaled-down llama3.2 family)
    base = get_config("llama3.2-3b")
    cfg = dataclasses.replace(
        base,
        num_layers=8,
        d_model=640,
        num_heads=10,
        num_kv_heads=2,
        head_dim=64,
        d_ff=1792,
        vocab_size=32000,
        remat=False,
        schedule="wsd",
    )
    return cfg.reduced() if reduced else cfg


def run(steps=200, kill_at=None, ckpt_dir=None, ckpt_every=40, device="cuda", reduced=False):
    """Trains through ``TrainSupervisor``; returns its report and the wall
    seconds."""
    cfg = build_cfg(reduced)
    print(f"params: {cfg.param_count()/1e6:.1f}M on {device}")
    sup = TrainSupervisor(cfg, SHAPE, ckpt_dir or str(ROOT / "build" / "train_lm"), ckpt_every=ckpt_every,
                          device=device)
    injector = FailureInjector([kill_at]) if kill_at is not None else None
    t0 = time.time()
    report = sup.run(steps, injector=injector)
    return report, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    report, dt = run(args.steps, args.kill_at, args.ckpt_dir, args.ckpt_every, args.device, args.reduced)
    print(
        f"steps={report.steps_run} restarts={report.restarts} "
        f"checkpoints={report.checkpoints} stragglers={report.straggler_steps}"
    )
    if not report.losses:
        print(f"the checkpoints are already at --steps {args.steps}")
        return report
    print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f}  ({dt:.0f}s)")
    if not report.losses[-1] < report.losses[0]:
        raise SystemExit(f"the loss did not fall: {report.losses[0]} -> {report.losses[-1]}")
    return report


if __name__ == "__main__":
    main()
