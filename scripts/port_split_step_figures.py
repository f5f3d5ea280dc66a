"""The figures ``tests/test_torch_tp_recurrent.py`` holds the split train
step to, printed: for each recurrent config the test runs on a mesh, the
largest relative difference of the sharded step's losses and gradient norms
from the unsharded step's, of each step's new state from the unsharded
optimizer fed its gradients, and of each gradient leaf (the worst four).

    PYTHONPATH=src python scripts/port_split_step_figures.py [--mesh 1x4]

The same gloo run as the test's (one process a rank, ``run_ranks``), so
its bounds apply: 1e-5 for the losses, norms and gradients, 1e-6 for the
update. ``ATEN_CPU_CAPABILITY`` (``default``, ``avx2``, ``avx512``) picks
ATen's CPU kernels for the ranks, which the figures depend on.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1x4", help="a mesh of tests/test_torch_tp_recurrent.py's MESHES")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_tp_recurrent as tp
    from test_torch_distributed import run_ranks

    names = ",".join(n for m, n in tp.CASES if m == args.mesh)
    with tempfile.TemporaryDirectory() as tmp:
        out = run_ranks(Path(tmp), "recurrent", args.mesh, names, script_text=tp._CASES, timeout=400)
    for name, rec in out.items():
        grads = sorted(rec["grad_rel"].items(), key=lambda kv: -kv[1])
        print(f"{args.mesh} {name}: loss_rel {rec['loss_rel']:.3e} norm_rel {rec['norm_rel']:.3e} "
              f"update_rel {rec['update_rel']:.3e} grad_rel {grads[0][1]:.3e} ({grads[0][0]}); "
              + ", ".join(f"{p} {r:.2e}" for p, r in grads[:4]))


if __name__ == "__main__":
    main()
