"""Training launcher, the counterpart of the JAX package's ``launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 50 [--ckpt-dir DIR] [--device cpu]

Runs ``TrainSupervisor`` on ``cuda`` unless ``--device cpu`` is given; with
no card and no ``--device cpu`` it raises. Checkpoints go to ``--ckpt-dir``
(by default ``build/train_ckpt/<arch>`` under the checkout, git-ignored); a
run resumes from the latest checkpoint there. ``--devices`` and ``--mesh``
(the reference's host-device mesh) raise until ROADMAP.md §1 item 7.
"""
import argparse
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--devices", type=int, default=0, help="not ported (ROADMAP.md §1 item 7)")
    ap.add_argument("--mesh", default=None, help="not ported (ROADMAP.md §1 item 7)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.devices or args.mesh:
        raise SystemExit("--devices and --mesh are not ported yet (ROADMAP.md §1 item 7)")

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.runtime.train_loop import TrainSupervisor

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("train", args.seq_len, args.global_batch, "train")
    ckpt_dir = args.ckpt_dir or str(ROOT / "build" / "train_ckpt" / args.arch)
    sup = TrainSupervisor(cfg, shape, ckpt_dir, ckpt_every=args.ckpt_every, device=args.device)
    report = sup.run(args.steps)
    if not report.losses:
        print(f"final_step={report.final_step}: the checkpoints in {ckpt_dir} are already at --steps")
        return report
    print(
        f"final_step={report.final_step} loss {report.losses[0]:.3f} -> "
        f"{report.losses[-1]:.3f} checkpoints={report.checkpoints}"
    )
    return report


if __name__ == "__main__":
    main()
