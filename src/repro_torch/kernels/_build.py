"""Build the package's CUDA sources with nvcc at first use, load them with ctypes.

Every ``repro_torch/csrc/<name>.cu`` becomes ``build/repro_torch_kernels/
lib<name>.so`` under the checkout's root (git-ignored). The first call that
needs any kernel compiles every source whose library is missing or older
than the source or than any shared header ``csrc/*.cuh``, one ``nvcc``
process per source, all started together; ptxas's register and
shared-memory report lands in ``lib<name>.log`` beside it. Each C
entry point returns ``cudaGetLastError()``; :func:`check` raises on non-zero.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, Callable[..., int]] = {}
_sm_counts: Dict[int, int] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def stale_sources(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> List[Path]:
    """The sources in ``csrc`` whose ``build_dir/lib<name>.so`` is missing or
    older than the source or than any shared header ``csrc/*.cuh``."""
    headers = max((h.stat().st_mtime for h in csrc.glob("*.cuh")), default=0.0)
    stale = []
    for src in sorted(csrc.glob("*.cu")):
        lib = build_dir / f"lib{src.stem}.so"
        if not lib.exists() or lib.stat().st_mtime < max(src.stat().st_mtime, headers):
            stale.append(src)
    return stale


def build_all() -> float:
    """Compile every stale source in parallel; return the wall seconds spent."""
    t0 = time.perf_counter()
    stale = stale_sources()
    if stale:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in stale:
            tmp = BUILD_DIR / f"lib{src.stem}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            (BUILD_DIR / f"lib{src.stem}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, _lib_path(src.stem))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib: str, name: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``name`` of ``lib<lib>.so``, building it if needed."""
    key = f"{lib}.{name}"
    fn = _fns.get(key)
    if fn is None:
        with _lock:
            if lib not in _libs:
                build_all()
                _libs[lib] = ctypes.CDLL(str(_lib_path(lib)))
            fn = getattr(_libs[lib], name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return fn


H100_SMS = 132  # the SMs a meta tensor's route rules see (the dry-run's memory pass)


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once a device; the H100's for a
    meta tensor."""
    if device.type == "meta":
        return H100_SMS
    dev = device.index if device.index is not None else torch.cuda.current_device()
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_counts[dev]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
