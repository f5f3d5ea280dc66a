#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card at the
   live path's shapes (and prefill/test shapes), and times kernel, plain
   version and one library call (a yardstick only: the port never calls it);
4. runs qwen3-1.7b at full width (2 layers, S = 64) through the kernels and
   holds its logits against the plain version of the same weights on the CPU;
5. serves qwen3-1.7b + llama3.2-3b at their published widths and depths under
   150% oversubscription through ``MultiModelServer`` with 2 MiB pages: every
   migration is a pinned-host <-> HBM copy. It checks that every request is
   served, that bytes moved both ways, that each step launched 197
   ``stream_matmul`` and 28 ``flash_attention`` kernels, and that the steps'
   logits are bit-identical to the same steps run all-resident;
6. prints the kernels line and, last, the device line.

Any failure raises, so the exit code is not 0; so is a run without a card or
without ``src/repro_torch`` beside this file. Needs no network and no JAX.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 5e-2  # rtol = atol, the reference's kernel-test tolerance
PAGE_SIZE = 2 << 20  # UVM large page
ARCHS = ["qwen3-1.7b", "llama3.2-3b"]
REQUESTS_PER_MODEL = 6
# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
# and operations/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}


def log(*args):
    print(*args, flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build
    from repro_torch.kernels import _build

    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s into {_build.BUILD_DIR}")
    for log_file in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {log_file.stem}: {line.strip()}")

    bench = Bench(torch, dev)
    mm = check_stream_matmul(torch, dev, bench)
    fa = check_flash_attention(torch, dev, bench)
    check_model_against_cpu(torch, dev)
    launches, steps = serve_slice(torch, dev)

    kernels = []
    for name, rec in (("stream_matmul", mm), ("flash_attention", fa)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": launches[name],
            "launches_per_step": launches[name] / steps,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "shapes": rec["shapes"],
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


class Bench:
    """CUDA-event timing, median of ``reps`` launches after a warm-up, with
    the 50 MB L2 flushed before each launch (the live path reads every weight
    once a step, so it finds them cold)."""

    def __init__(self, torch, dev, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, out, ref) -> float:
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL, atol=TOL)
    return float((out.float() - ref.float()).abs().max())


def live_projection_shapes():
    """(K, N, calls per step) of every x @ W of one live step, per model."""
    from repro_torch.configs import get_config

    shapes = {}
    for arch in ARCHS:
        c = get_config(arch)
        d, hd, L = c.d_model, c.resolved_head_dim(), c.num_layers
        per_layer = [
            (d, c.num_heads * hd), (d, c.num_kv_heads * hd), (d, c.num_kv_heads * hd),
            (c.num_heads * hd, d), (d, c.d_ff), (d, c.d_ff), (c.d_ff, d),
        ]
        counts = {}
        for kn in per_layer:
            counts[kn] = counts.get(kn, 0) + L
        counts[(d, c.vocab_size)] = counts.get((d, c.vocab_size), 0) + 1
        shapes[arch] = counts
    return shapes


def check_stream_matmul(torch, dev, bench):
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.kernels.streammm.ref import stream_matmul_ref

    gen = torch.Generator(dev).manual_seed(0)

    def operands(m, k, n, dtype):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dtype)
        return x, w

    log("stream_matmul against stream_matmul_ref (ms: CUDA events, cold L2):")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    errs, bound_kinds = [], set()
    per_model = {}
    for arch, counts in live_projection_shapes().items():
        per_model[arch] = dict(ms=0.0, bound_ms=0.0, library_ms=0.0)
        for (k, n), calls in counts.items():
            x, w = operands(1, k, n, torch.bfloat16)
            out = stream_matmul(x, w)
            err = max_err(torch, out, stream_matmul_ref(x, w))
            if not torch.equal(out, stream_matmul(x, w)):
                raise AssertionError(f"stream_matmul (1,{k},{n}) is not deterministic")
            t = bench.ms(lambda: stream_matmul(x, w))
            t_plain = bench.ms(lambda: stream_matmul_ref(x, w))
            t_lib = bench.ms(lambda: torch.matmul(x, w))
            b, kind = bound(2 * (k + k * n + n), 2 * k * n, torch.bfloat16)
            bound_kinds.add(kind)
            errs.append(err)
            for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", b), ("library_ms", t_lib)):
                totals[key] += calls * val
                if key in per_model[arch]:
                    per_model[arch][key] += calls * val
            log(f"  {arch} M=1 K={k} N={n} x{calls}/step: err {err:.2e} kernel {t:.4f} ms "
                f"bound {b:.4f} ms ({100 * b / t:.0f}%) plain {t_plain:.4f} ms torch.matmul {t_lib:.4f} ms")
    for m, k, n, dtype in ((256, 2048, 2048, torch.bfloat16), (1, 2048, 2048, torch.float32),
                           (64, 2048, 6144, torch.float32), (3, 1000, 999, torch.bfloat16)):
        x, w = operands(m, k, n, dtype)
        out = stream_matmul(x, w, out_dtype=dtype)
        err = max_err(torch, out, stream_matmul_ref(x, w, out_dtype=dtype))
        t = bench.ms(lambda: stream_matmul(x, w, out_dtype=dtype))
        errs.append(err)
        log(f"  off-path M={m} K={k} N={n} {dtype}: err {err:.2e} kernel {t:.4f} ms")
    for arch, t in per_model.items():
        log(f"  one live step of {arch}: kernel {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, "
            f"torch.matmul {t['library_ms']:.3f} ms")
    log(f"  one live step of each model: kernel {totals['ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms")
    return {
        "source": "src/repro_torch/csrc/streammm.cu",
        "replaces": "src/repro/kernels/streammm/kernel.py:50",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "shapes": "sum over one live step of qwen3-1.7b and one of llama3.2-3b (197 calls each)",
        **totals,
    }


def attention_pairs(sq, skv, causal, window):
    """(query, key) pairs the mask keeps: the work this input needs."""
    n = 0
    for s in range(sq):
        lo = max(0, s - window + 1) if window > 0 else 0
        hi = min(skv, s + 1) if causal else skv
        n += max(0, hi - lo)
    return n


def check_flash_attention(torch, dev, bench):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(dev).manual_seed(1)
    cases = [
        # (label, B, Sq, Skv, H, Hkv, D, causal, window, dtype, live calls per step)
        ("qwen3 live", 1, 1, 1, 16, 8, 128, True, 0, torch.bfloat16, 28),
        ("llama3.2 live", 1, 1, 1, 24, 8, 128, True, 0, torch.bfloat16, 28),
        ("prefill causal", 1, 2048, 2048, 16, 8, 128, True, 0, torch.bfloat16, 0),
        ("prefill window", 1, 2048, 2048, 16, 8, 128, True, 512, torch.bfloat16, 0),
        ("test 1", 1, 128, 128, 4, 4, 32, True, 0, torch.bfloat16, 0),
        ("test 2", 2, 256, 256, 8, 2, 64, True, 0, torch.float32, 0),
        ("test 3", 2, 128, 128, 4, 1, 32, True, 64, torch.bfloat16, 0),
        ("test 4", 1, 128, 128, 4, 4, 32, False, 0, torch.float32, 0),
        ("S=1 f32", 1, 1, 1, 16, 8, 128, True, 0, torch.float32, 0),
    ]
    log("flash_attention against attention_ref (ms: CUDA events):")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    errs, bound_kinds = [], set()
    for label, b, sq, skv, h, hkv, d, causal, window, dtype, calls in cases:
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        out = flash_attention(q, k, v, **kw)
        err = max_err(torch, out, attention_ref(q, k, v, **kw))
        errs.append(err)
        t = bench.ms(lambda: flash_attention(q, k, v, **kw))
        t_plain = bench.ms(lambda: attention_ref(q, k, v, **kw))
        # yardstick: PyTorch's fused attention on (B, H, S, D) copies
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if window > 0:
            i = torch.arange(sq, device=dev)[:, None]
            j = torch.arange(skv, device=dev)[None, :]
            mask = (i - j < window) & ((i >= j) if causal else True)
        sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None, enable_gqa=h != hkv)
        t_lib = bench.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw))
        elem = torch.tensor([], dtype=dtype).element_size()
        nbytes = elem * (2 * q.numel() + k.numel() + v.numel())
        bt, kind = bound(nbytes, 4 * b * h * d * attention_pairs(sq, skv, causal, window), dtype)
        if calls:
            bound_kinds.add(kind)
            for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                totals[key] += calls * val
        log(f"  {label} B={b} Sq={sq} Skv={skv} H={h} Hkv={hkv} D={d} causal={causal} "
            f"window={window} {dtype}: err {err:.2e} kernel {t:.4f} ms bound {bt:.5f} ms ({kind}) "
            f"plain {t_plain:.4f} ms sdpa {t_lib:.4f} ms")
    return {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "shapes": "sum over one live step of qwen3-1.7b and one of llama3.2-3b (28 calls each)",
        **totals,
    }


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def check_model_against_cpu(torch, dev):
    """qwen3-1.7b at full width, 2 layers, S = 64: logits of the kernel path
    on the card against the plain path on the CPU, from the same weights.

    Gated at the tolerance: (1) bf16, the CPU taking each kernel's plain
    version (``stream_matmul_ref``, ``attention_ref``), the same arithmetic up
    to summation order; (2) the same weights in f32, where bf16 rounding
    cannot hide or amplify a difference. Reported: (3) bf16 against the CPU
    ``forward`` as it runs there, whose ``attend`` (a copy of the JAX
    package's) rounds scores and probabilities to bf16 where the kernel keeps
    f32."""
    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(0))
    batch_card, batch_cpu = {"tokens": tokens.to(dev)}, {"tokens": tokens}
    t0 = time.perf_counter()

    def kernel_plain_attend(q, k, v, *, causal, window=None, **_):
        return attention_ref(q, k, v, causal=causal, window=window or 0)

    with torch.inference_mode():
        on_card = fns.forward(params, batch_card).cpu()
        cpu_params = tree_map(lambda t: t.cpu(), params)
        attend = layers.attend
        layers.attend = kernel_plain_attend
        try:
            kernels_plain = fns.forward(cpu_params, batch_cpu)
        finally:
            layers.attend = attend
        cpu_forward = fns.forward(cpu_params, batch_cpu)
        f32_card = fns.forward(tree_map(lambda t: t.float(), params), batch_card).cpu()
        f32_cpu = fns.forward(tree_map(lambda t: t.float(), cpu_params), batch_cpu)
    for out in (on_card, f32_card):
        if out.shape != (1, 64, cfg.vocab_size) or not torch.isfinite(out.float()).all():
            raise AssertionError(f"model: logits {tuple(out.shape)} not finite / wrong shape")
    err = max_err(torch, on_card, kernels_plain)
    err32 = max_err(torch, f32_card, f32_cpu)
    diff = (on_card.float() - cpu_forward.float()).abs()
    beyond = int((diff > TOL + TOL * cpu_forward.float().abs()).sum())
    log(f"model qwen3-1.7b full width, 2 layers, S=64, |logits| max "
        f"{float(kernels_plain.float().abs().max()):.2f} ({time.perf_counter() - t0:.1f} s):")
    log(f"  bf16 card kernels vs CPU plain kernels: max abs err {err:.3e}")
    log(f"  f32  card kernels vs CPU plain forward: max abs err {err32:.3e}")
    log(f"  bf16 card kernels vs CPU forward (bf16 attend): max abs err {float(diff.max()):.3e}, "
        f"{beyond} of {diff.numel()} beyond rtol=atol={TOL} (reported, not gated)")
    return {"bf16_err": err, "f32_err": err32, "bf16_vs_attend_err": float(diff.max()),
            "bf16_vs_attend_beyond": beyond}


def serve_slice(torch, dev):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.runtime.serve_loop import MultiModelServer, Request

    t0 = time.perf_counter()
    server = MultiModelServer(ARCHS, device=dev, full=True, page_size=PAGE_SIZE)
    rt = server.runtime
    tasks = list(rt.tasks.values())
    footprint = sum(t.footprint_bytes() for t in tasks)
    budget = rt.pool.capacity * rt.page_size
    log(f"serve: {len(tasks)} models at full width, footprint {footprint / 1e9:.3f} GB, "
        f"budget {budget / 1e9:.3f} GB ({100 * footprint / budget:.0f}%), page {PAGE_SIZE} B, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    # time every residency sync (the runtime's copies are synchronous), split
    # into those of the proactive switch and those of demand faults
    syncs = []  # (demand fault?, seconds, bytes in, bytes out)
    in_fault = [False]
    sync, fault_in = rt._sync_residency, rt._fault_in

    def timed_sync():
        b_in, b_out = rt.stats.migrated_in_bytes, rt.stats.migrated_out_bytes
        s0 = time.perf_counter()
        sync()
        syncs.append((in_fault[0], time.perf_counter() - s0,
                      rt.stats.migrated_in_bytes - b_in, rt.stats.migrated_out_bytes - b_out))

    def tagged_fault_in(task):
        in_fault[0] = True
        try:
            fault_in(task)
        finally:
            in_fault[0] = False

    rt._sync_residency, rt._fault_in = timed_sync, tagged_fault_in

    # record each step's logits and its time (synchronised) inside the served run
    outputs = {t.task_id: [] for t in tasks}
    step_s = {t.task_id: [] for t in tasks}
    for t in tasks:
        def timed(i, t=t, step=t.run_step):
            torch.cuda.synchronize(dev)
            s0 = time.perf_counter()
            out = step(i)
            torch.cuda.synchronize(dev)
            step_s[t.task_id].append(time.perf_counter() - s0)
            outputs[t.task_id].append((i, out))
            return out
        t.run_step = timed

    stream_matmul.launches = 0
    flash_attention.launches = 0
    for i in range(REQUESTS_PER_MODEL * len(tasks)):
        server.submit(Request(model=i % len(tasks), arrival_s=time.perf_counter()))
    t0 = time.perf_counter()
    stats = server.serve(wall_budget_s=600.0)
    serve_s = time.perf_counter() - t0
    launches = {"stream_matmul": stream_matmul.launches, "flash_attention": flash_attention.launches}
    for t in tasks:
        del t.run_step
    del rt._sync_residency, rt._fault_in

    steps = sum(rt.stats.steps.values())
    ls = rt.stats
    log(f"serve: {serve_s:.2f} s, served {stats.served}, "
        f"p99 {[f'{1e3 * stats.p99(m):.1f} ms' for m in stats.served]}, steps {ls.steps}")
    log(f"serve: migrated_in {ls.migrated_in_bytes} B, migrated_out {ls.migrated_out_bytes} B, "
        f"demand_faults {ls.demand_faults}, switches {len(ls.switch_wall_s)}")
    log(f"serve: per-switch coordinator wall {[f'{1e3 * s:.2f}' for s in ls.coordinator_wall_s]} ms; "
        f"per-switch plan+copies {[f'{1e3 * s:.1f}' for s in ls.switch_wall_s]} ms")
    for fault, label in ((False, "switch syncs"), (True, "demand-fault syncs")):
        sel = [x for x in syncs if x[0] == fault]
        secs = sum(x[1] for x in sel)
        b_in, b_out = sum(x[2] for x in sel), sum(x[3] for x in sel)
        rate = (b_in + b_out) / secs / 1e9 if secs else 0.0
        log(f"serve: {label}: {len(sel)} calls, {secs:.3f} s, in {b_in} B, out {b_out} B, "
            f"{rate:.2f} GB/s (synchronous pinned copies, page walk included)")
    for t in tasks:
        wbytes = sum(s.nbytes for s in t.segments)
        med = statistics.median(step_s[t.task_id])
        log(f"serve: {t.cfg.name} step median {1e3 * med:.3f} ms over {len(step_s[t.task_id])} steps, "
            f"weight-bytes bound {1e3 * wbytes / HBM_BYTES_PER_S:.3f} ms ({wbytes} B)")
    log(f"serve: launches {launches} over {steps} steps")

    if stats.served != {t.task_id: REQUESTS_PER_MODEL for t in tasks} or any(server.queues.values()):
        raise AssertionError(f"not every request was served: {stats.served}")
    if not (ls.migrated_in_bytes > 0 and ls.migrated_out_bytes > 0):
        raise AssertionError("no real migration in both directions")
    # 7 projections a layer plus the LM head, one attention a layer:
    # 197 and 28 a step at the published depth of both models
    want = {
        "stream_matmul": sum((7 * t.cfg.num_layers + 1) * ls.steps[t.task_id] for t in tasks),
        "flash_attention": sum(t.cfg.num_layers * ls.steps[t.task_id] for t in tasks),
    }
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")

    # the same steps all-resident give the same bits
    for t in tasks:
        for s in t.segments:
            if s.device is None:
                s.device = s.host.to(dev)
        for i, out in outputs[t.task_id]:
            again = t.run_step(i)
            if not torch.equal(again, out) or not torch.isfinite(out.float()).all():
                raise AssertionError(f"{t.cfg.name} step {i}: oversubscribed != all-resident")
    log(f"serve: {sum(len(v) for v in outputs.values())} oversubscribed steps bit-identical to all-resident")
    for t in tasks:
        profile_steps(torch, dev, t, statistics.median(step_s[t.task_id]))
    return launches, steps


def profile_steps(torch, dev, task, step_wall_s: float, n: int = 3) -> None:
    """Device time of ``n`` all-resident steps from torch.profiler, against
    the median step wall time of the served run (taken without the profiler,
    whose own host cost would inflate the wall): the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            task.run_step(i)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6 / n
    if busy_s == 0:
        log(f"profile: {task.cfg.name} device time not measured (the profiler saw no kernel)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    log(f"profile: {task.cfg.name} device busy {1e3 * busy_s:.3f} ms a step; of a "
        f"{1e3 * step_wall_s:.3f} ms step the device idles {100 * (1 - busy_s / step_wall_s):.1f}%; "
        "top kernels (ms a step): " + ", ".join(
            f"{e.key[:48]} {e.self_device_time_total * 1e-3 / n:.3f}" for e in top))


if __name__ == "__main__":
    main()
