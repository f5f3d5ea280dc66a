"""Training launcher, the counterpart of the JAX package's ``launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 50 [--ckpt-dir DIR] [--device cpu] [--devices 8 --mesh 2x4]

Runs ``TrainSupervisor`` on ``cuda`` unless ``--device cpu`` is given; with
no card and no ``--device cpu`` it raises. Checkpoints go to ``--ckpt-dir``
(by default ``build/train_ckpt/<arch>`` under the checkout, git-ignored); a
run resumes from the latest checkpoint there, on whatever mesh it is given
(elastic re-mesh).

``--mesh AxB`` (data, model) or ``AxBxC`` (pod, data, model) trains on a
mesh of that many ranks, the state sharded by ``sharding.specs``. On the
CPU, ``--devices N`` starts N gloo ranks, one process each (the counterpart
of the reference's N fake host devices), and N must be the mesh's size. The
card is one: on ``cuda`` the mesh must be of size 1 (``--mesh 1x1``), one
NCCL rank in this process, and ``--devices`` above 1 raises.
"""
import argparse
import os
import tempfile
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
    ap.add_argument("--devices", type=int, default=0, help="ranks to start (gloo, CPU only)")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 => (data=2, model=4)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.common import resolve_device

    device = resolve_device(args.device)
    if not (args.devices or args.mesh):
        return _train(args, device)
    if not args.mesh:
        raise SystemExit("--devices N needs --mesh AxB[xC] of N ranks")
    ms = parse_mesh(args.mesh)
    ranks = args.devices or ms.size
    if ranks != ms.size:
        raise SystemExit(f"--mesh {args.mesh} needs {ms.size} ranks, not --devices {ranks}")
    if device.type == "cuda" and ranks > 1:
        raise SystemExit("one card: a mesh above 1 rank runs on the CPU (--device cpu, gloo ranks); "
                         "on cuda use --mesh 1x1")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if ranks == 1:
            return _rank(0, 1, store, args)
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(rank, ranks, store, args)) for rank in range(ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [rank for rank, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise SystemExit(f"ranks {failed} failed")


def _rank(rank: int, world: int, store: str, args):
    """One rank of a mesh run: joins the group, builds the mesh and the
    state's shardings, trains, leaves the group; rank 0 prints."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, make_mesh, parse_mesh
    from repro_torch.launch.steps import abstract_train_state
    from repro_torch.sharding.specs import state_shardings

    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_ranks(rank, world, store, device)
    try:
        ms = parse_mesh(args.mesh)
        mesh = make_mesh(ms.sizes, ms.axis_names, device)
        cfg = _config(args)
        return _train(args, device, mesh=mesh, shardings=state_shardings(cfg, abstract_train_state(cfg), mesh),
                      quiet=rank != 0)
    finally:
        dist.destroy_process_group()


def _config(args):
    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def _train(args, device, mesh=None, shardings=None, quiet=False):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.runtime.train_loop import TrainSupervisor

    cfg = _config(args)
    shape = ShapeSpec("train", args.seq_len, args.global_batch, "train")
    ckpt_dir = args.ckpt_dir or str(ROOT / "build" / "train_ckpt" / args.arch)
    sup = TrainSupervisor(cfg, shape, ckpt_dir, mesh=mesh, shardings=shardings, ckpt_every=args.ckpt_every,
                          device=device)
    report = sup.run(args.steps)
    if quiet:
        return report
    if not report.losses:
        print(f"final_step={report.final_step}: the checkpoints in {ckpt_dir} are already at --steps")
        return report
    print(
        f"final_step={report.final_step} loss {report.losses[0]:.3f} -> "
        f"{report.losses[-1]:.3f} checkpoints={report.checkpoints}"
        + (f" mesh={args.mesh}" if mesh is not None else ""), flush=True
    )
    return report


if __name__ == "__main__":
    main()
