"""Quickstart on the PyTorch port: train a reduced qwen3-1.7b for 30 steps
on synthetic data through ``make_train_state`` / ``make_train_step``, the
counterpart of ``examples/quickstart.py`` (seq 128, batch 8, peak lr 1e-3,
5 warmup steps of 30).

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu] [--steps 30]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models.common import resolve_device
from repro_torch.tree import leaves

TOTAL_STEPS = 30


def run(device: str = "cuda", steps: int = TOTAL_STEPS):
    """Trains for ``steps`` steps (the schedule is the reference's 30);
    returns the losses, one a step."""
    dev = resolve_device(device)
    cfg = get_config("qwen3-1.7b").reduced()
    shape = ShapeSpec("quickstart", seq_len=128, global_batch=8, kind="train")
    pipe = pipeline_for(cfg, shape)

    state = make_train_state(cfg, torch.Generator(dev).manual_seed(0))
    step = make_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=TOTAL_STEPS)

    print(f"arch={cfg.name} (reduced) params="
          f"{sum(p.numel() for p in leaves(state['params'])):,} on {dev}")
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  gnorm {float(m['grad_norm']):.2f}")
    print("done — loss should have dropped from ~ln(512)=6.24")
    return losses


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--steps", type=int, default=TOTAL_STEPS)
    args = parser.parse_args(argv)
    return run(args.device, args.steps)


if __name__ == "__main__":
    main()
