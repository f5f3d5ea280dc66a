#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card at every
   shape the live step, prefill and a decode step give it (and at the
   reference's test shapes), and times kernel, plain version and one library
   call (a yardstick only: the port never calls it), weighted by each path's
   calls a step;
4. runs qwen3-1.7b at full width (2 layers, S = 64) through the kernels and
   holds its logits against the plain version of the same weights on the CPU;
   then prefills 64 tokens and decodes 4 more at the same width, held against
   the CPU's plain versions and against ``forward`` over the same tokens;
5. serves qwen3-1.7b + llama3.2-3b at their published widths and depths under
   150% oversubscription through ``MultiModelServer`` with 2 MiB pages: every
   migration is a pinned-host <-> HBM copy. It checks that every request is
   served, that bytes moved both ways, that each step launched 197
   ``stream_matmul``, 28 ``flash_attention`` and no ``paged_attention``
   kernels, and that the steps' logits are bit-identical to the same steps
   run all-resident;
6. runs the decode path of both models at their published widths and depths:
   4 prompts of 1024 tokens through ``make_prefill_step``, then 64 greedy
   steps through ``make_serve_step`` in a cache of 1088 slots. It checks the
   launches of prefill and of every step, that the logits are finite, and
   that they agree with one ``forward`` over the same 1088 tokens;
7. prints the kernels line and, last, the device line.

Any failure raises, so the exit code is not 0; so is a run without a card or
without ``src/repro_torch`` beside this file. Needs no network and no JAX.
"""
import contextlib
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
# The decode path (phase 6): prompts, prompt length, greedy steps, cache slots.
DECODE_B, PROMPT, DECODE_STEPS = 4, 1024, 64
DECODE_SMAX = PROMPT + DECODE_STEPS
# Decode logits against one forward over the same tokens, relative L2 over
# all of them. Both paths round to bf16 after every projection, norm and
# attention (about 10 places a layer) but at other places and after sums in
# another order, so they differ by a random walk of bf16 steps (2^-9
# relative): about sqrt(28 * 10) * 2^-9 = 3.3e-2 over 28 layers. A wrong
# slot, position or page gives an error of order 1. The gate is 3x the walk.
DECODE_REL_L2 = 1e-1
DECODE_TOL = 8e-2  # rtol = atol, the reference's decode-vs-forward tolerance
# paged_attention is also gated at max |out - ref| <= PA_REL * rms(ref): over
# a thousand slots of randn inputs its outputs have an rms near 0.05, so TOL
# alone is as large as an output and would pass a dropped page. PA_REL is
# about 10x the bf16 error measured at those shapes (2.4e-4).
PA_REL = 5e-2
PATHS = ("serve", "prefill", "decode")
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
    pa = check_paged_attention(torch, dev, bench)
    check_model_against_cpu(torch, dev)
    check_decode_against_cpu(torch, dev)
    # each path: its launches, read with every count set to 0 just before it
    paths = {"serve": serve_slice(torch, dev)}
    paths.update(decode_slice(torch, dev))

    # per kernel: launches on each path, and kernel / plain / bound / library
    # ms of one step of that path for each model, weighted by the calls a
    # step makes at each shape; the top-level ms sum one step of every path
    kernels = []
    for name, rec in (("stream_matmul", mm), ("flash_attention", fa), ("paged_attention", pa)):
        by_path = {}
        for path, (launches, steps) in paths.items():
            by_path[path] = {"launches": launches[name], "launches_per_step": launches[name] / steps,
                             **rec["by_path"][path]}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": sum(p["launches"] for p in by_path.values()),
            "max_abs_err": rec["max_abs_err"],
            **{key: sum(p[key] for p in by_path.values())
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": rec["bound_by"],
            "by_path": by_path,
        })
    unused = [k["name"] for k in kernels if k["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels never launched on a main path: {unused}")
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


def projection_shapes():
    """{path: {arch: {(M, K, N): calls a step}}}: every x @ W of one step of
    each main path: the live step (M = 1), a prefill of DECODE_B prompts
    (M = DECODE_B * PROMPT for the layers, M = DECODE_B for the LM head on the
    last position) and a decode step (M = DECODE_B)."""
    from repro_torch.configs import get_config

    shapes = {path: {} for path in PATHS}
    for arch in ARCHS:
        c = get_config(arch)
        d, hd, L = c.d_model, c.resolved_head_dim(), c.num_layers
        per_layer = [
            (d, c.num_heads * hd), (d, c.num_kv_heads * hd), (d, c.num_kv_heads * hd),
            (c.num_heads * hd, d), (d, c.d_ff), (d, c.d_ff), (c.d_ff, d),
        ]
        for path, m_layer, m_head in (("serve", 1, 1), ("prefill", DECODE_B * PROMPT, DECODE_B),
                                      ("decode", DECODE_B, DECODE_B)):
            counts = {}
            for k, n in per_layer:
                counts[(m_layer, k, n)] = counts.get((m_layer, k, n), 0) + L
            counts[(m_head, d, c.vocab_size)] = counts.get((m_head, d, c.vocab_size), 0) + 1
            shapes[path][arch] = counts
    return shapes


def path_totals():
    return {path: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0) for path in PATHS}


def check_stream_matmul(torch, dev, bench):
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.kernels.streammm.ref import stream_matmul_ref

    gen = torch.Generator(dev).manual_seed(0)

    def operands(m, k, n, dtype):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dtype)
        return x, w

    log("stream_matmul against stream_matmul_ref at every shape of each path (ms: CUDA events, cold L2):")
    totals = path_totals()
    errs, bound_kinds, measured = [], set(), {}
    for path, by_arch in projection_shapes().items():
        for arch, counts in by_arch.items():
            step = dict(ms=0.0, bound_ms=0.0, library_ms=0.0)
            for (m, k, n), calls in counts.items():
                if (m, k, n) not in measured:
                    x, w = operands(m, k, n, torch.bfloat16)
                    out = stream_matmul(x, w)
                    err = max_err(torch, out, stream_matmul_ref(x, w))
                    if not torch.equal(out, stream_matmul(x, w)):
                        raise AssertionError(f"stream_matmul ({m},{k},{n}) is not deterministic")
                    t = bench.ms(lambda: stream_matmul(x, w))
                    t_plain = bench.ms(lambda: stream_matmul_ref(x, w))
                    t_lib = bench.ms(lambda: torch.matmul(x, w))
                    b, kind = bound(2 * (m * k + k * n + m * n), 2 * m * k * n, torch.bfloat16)
                    measured[(m, k, n)] = dict(ms=t, plain_ms=t_plain, bound_ms=b, library_ms=t_lib)
                    errs.append(err)
                    bound_kinds.add(kind)
                    del x, w, out
                    log(f"  M={m} K={k} N={n}: err {err:.2e} kernel {t:.4f} ms bound {b:.4f} ms "
                        f"({kind}, {100 * b / t:.0f}%) plain {t_plain:.4f} ms torch.matmul {t_lib:.4f} ms")
                for key, val in measured[(m, k, n)].items():
                    totals[path][key] += calls * val
                    if key in step:
                        step[key] += calls * val
            log(f"  one {path} step of {arch} ({sum(counts.values())} calls): kernel {step['ms']:.3f} ms, "
                f"bound {step['bound_ms']:.3f} ms, torch.matmul {step['library_ms']:.3f} ms")
    for m, k, n, dtype in ((256, 2048, 2048, torch.bfloat16), (1, 2048, 2048, torch.float32),
                           (64, 2048, 6144, torch.float32), (3, 1000, 999, torch.bfloat16)):
        x, w = operands(m, k, n, dtype)
        out = stream_matmul(x, w, out_dtype=dtype)
        err = max_err(torch, out, stream_matmul_ref(x, w, out_dtype=dtype))
        t = bench.ms(lambda: stream_matmul(x, w, out_dtype=dtype))
        errs.append(err)
        log(f"  off-path M={m} K={k} N={n} {dtype}: err {err:.2e} kernel {t:.4f} ms")
    return {
        "source": "src/repro_torch/csrc/streammm.cu",
        "replaces": "src/repro/kernels/streammm/kernel.py:50",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
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
        # (label, B, Sq, Skv, H, Hkv, D, causal, window, dtype, calls a step by path)
        ("qwen3 live", 1, 1, 1, 16, 8, 128, True, 0, torch.bfloat16, {"serve": 28}),
        ("llama3.2 live", 1, 1, 1, 24, 8, 128, True, 0, torch.bfloat16, {"serve": 28}),
        ("qwen3 prefill", DECODE_B, PROMPT, PROMPT, 16, 8, 128, True, 0, torch.bfloat16, {"prefill": 28}),
        ("llama3.2 prefill", DECODE_B, PROMPT, PROMPT, 24, 8, 128, True, 0, torch.bfloat16, {"prefill": 28}),
        ("long causal", 1, 2048, 2048, 16, 8, 128, True, 0, torch.bfloat16, {}),
        ("long window", 1, 2048, 2048, 16, 8, 128, True, 512, torch.bfloat16, {}),
        ("test 1", 1, 128, 128, 4, 4, 32, True, 0, torch.bfloat16, {}),
        ("test 2", 2, 256, 256, 8, 2, 64, True, 0, torch.float32, {}),
        ("test 3", 2, 128, 128, 4, 1, 32, True, 64, torch.bfloat16, {}),
        ("test 4", 1, 128, 128, 4, 4, 32, False, 0, torch.float32, {}),
        ("S=1 f32", 1, 1, 1, 16, 8, 128, True, 0, torch.float32, {}),
    ]
    log("flash_attention against attention_ref (ms: CUDA events):")
    totals = path_totals()
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
        for path, n in calls.items():
            bound_kinds.add(kind)
            for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                totals[path][key] += n * val
        log(f"  {label} B={b} Sq={sq} Skv={skv} H={h} Hkv={hkv} D={d} causal={causal} "
            f"window={window} {dtype}: err {err:.2e} kernel {t:.4f} ms bound {bt:.5f} ms ({kind}) "
            f"plain {t_plain:.4f} ms sdpa {t_lib:.4f} ms")
    return {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
    }


def check_paged_attention(torch, dev, bench):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.layers import kv_page_tokens

    gen = torch.Generator(dev).manual_seed(2)
    # the decode path's lengths: 1025 .. 1088, one per row, in its page view
    decode_lengths = tuple(PROMPT + 1 + (DECODE_STEPS - 1) * i // (DECODE_B - 1) for i in range(DECODE_B))
    decode_pt = kv_page_tokens(DECODE_SMAX)
    mp = DECODE_SMAX // decode_pt
    cases = [
        # (label, B, H, Hkv, D, page_tokens, max_pages, lengths, permuted table,
        #  decode calls a step): the decode shapes of both models, then the
        #  reference's PA_CASES with its lengths, its growing-length case (one
        #  length a row), and g = 3 with a permuted table and a row of length 0
        ("qwen3 decode", DECODE_B, 16, 8, 128, decode_pt, mp, decode_lengths, False, 28),
        ("llama3.2 decode", DECODE_B, 24, 8, 128, decode_pt, mp, decode_lengths, False, 28),
        ("llama3.2 permuted", DECODE_B, 24, 8, 128, decode_pt, mp, decode_lengths, True, 0),
        ("test 1", 2, 4, 2, 32, 16, 4, (1, 8), False, 0),
        ("test 2", 3, 8, 1, 64, 32, 3, (1, 8, 15), False, 0),
        ("test 3", 1, 4, 4, 32, 16, 8, (1,), False, 0),
        ("growing", 5, 4, 2, 32, 16, 4, (1, 16, 17, 32, 64), False, 0),
        ("g=3 length 0", 3, 6, 2, 32, 8, 5, (37, 0, 40), True, 0),
    ]
    log("paged_attention against paged_attention_ref (ms: CUDA events, cold L2):")
    totals = path_totals()
    errs, bound_kinds = [], set()
    for label, b, h, hkv, d, pt, max_pages, lengths, permuted, calls in cases:
        for dtype in (torch.bfloat16, torch.float32):
            n_pool = b * max_pages + 3
            q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
            pool_k = torch.randn((n_pool, pt, hkv, d), generator=gen, device=dev).to(dtype)
            pool_v = torch.randn((n_pool, pt, hkv, d), generator=gen, device=dev).to(dtype)
            ids = torch.randperm(n_pool, generator=gen, device=dev) if permuted else torch.arange(n_pool, device=dev)
            table = ids[: b * max_pages].reshape(b, max_pages).to(torch.int32).contiguous()
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            args = (q, pool_k, pool_v, table, lens)
            out = paged_attention(*args)
            ref = paged_attention_ref(*args)
            err = max_err(torch, out, ref)
            rms = float(ref.float().pow(2).mean().sqrt())
            if not err <= PA_REL * rms:
                raise AssertionError(f"paged_attention {label} {dtype}: max abs err {err:.3e} "
                                     f"> {PA_REL} x rms(ref) {rms:.3e}")
            if not torch.equal(out, paged_attention(*args)):
                raise AssertionError(f"paged_attention {label} is not deterministic")
            for row, length in enumerate(lengths):
                if length == 0 and out[row].any():
                    raise AssertionError(f"paged_attention {label}: row {row} of length 0 is not zero")
            errs.append(err)
            t = bench.ms(lambda: paged_attention(*args))
            t_plain = bench.ms(lambda: paged_attention_ref(*args))
            # yardstick: PyTorch's fused attention over the contiguous cache
            # (the pages gathered in table order), masked past each length
            k_seq = pool_k[table.long()].reshape(b, max_pages * pt, hkv, d).transpose(1, 2).contiguous()
            v_seq = pool_v[table.long()].reshape(b, max_pages * pt, hkv, d).transpose(1, 2).contiguous()
            mask = (torch.arange(max_pages * pt, device=dev)[None, :] < lens[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :]
            t_lib = bench.ms(lambda: F.scaled_dot_product_attention(
                q4, k_seq, v_seq, attn_mask=mask, enable_gqa=h != hkv))
            elem = q.element_size()
            valid = sum(lengths)
            nbytes = (elem * (2 * q.numel() + 2 * valid * hkv * d)
                      + 4 * (b + sum(-(-n // pt) for n in lengths)))
            bt, kind = bound(nbytes, 4 * h * d * valid, dtype)
            if calls and dtype == torch.bfloat16:
                bound_kinds.add(kind)
                for key, val in (("ms", t), ("plain_ms", t_plain), ("bound_ms", bt), ("library_ms", t_lib)):
                    totals["decode"][key] += calls * val
            log(f"  {label} B={b} H={h} Hkv={hkv} D={d} pt={pt} pages={max_pages} lengths={list(lengths)} "
                f"{'permuted ' if permuted else ''}{dtype}: err {err:.2e} (rms {rms:.2e}) kernel {t:.4f} ms "
                f"bound {bt:.5f} ms ({kind}, {100 * bt / t:.0f}%) plain {t_plain:.4f} ms sdpa {t_lib:.4f} ms")
    return {
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:69",
        "max_abs_err": max(errs),
        "bound_by": "+".join(sorted(bound_kinds)),
        "by_path": totals,
    }


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@contextlib.contextmanager
def kernel_plain_attend():
    """``attend`` on the CPU as the flash_attention kernel's plain version
    (f32 scores and probabilities) instead of the copy of the JAX package's,
    which rounds them to bf16."""
    import repro_torch.models.layers as layers
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def attend(q, k, v, *, causal, window=None, **_):
        return attention_ref(q, k, v, causal=causal, window=window or 0)

    saved = layers.attend
    layers.attend = attend
    try:
        yield
    finally:
        layers.attend = saved


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
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(0))
    batch_card, batch_cpu = {"tokens": tokens.to(dev)}, {"tokens": tokens}
    t0 = time.perf_counter()

    with torch.inference_mode():
        on_card = fns.forward(params, batch_card).cpu()
        cpu_params = tree_map(lambda t: t.cpu(), params)
        with kernel_plain_attend():
            kernels_plain = fns.forward(cpu_params, batch_cpu)
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


def check_decode_against_cpu(torch, dev):
    """qwen3-1.7b at full width, 2 layers: prefill 64 tokens into a cache of
    68 slots, then 4 decode steps, on the card and on the CPU from the same
    weights. Gated: the card's logits (prefill's last and each step's)
    against the CPU taking the kernels' plain versions, at the tolerance as in
    phase 4; on the card, the same logits against ``forward`` over the same
    68 tokens, at the reference's decode tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(dev).manual_seed(0))
    b, s, n = 2, 64, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n), generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()

    def prefill_decode(params, tokens):
        logits, cache = fns.prefill(params, {"tokens": tokens[:, :s]}, max_seq=s + n)
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(params, cache, {"tokens": tokens[:, s + i : s + i + 1]})
            outs.append(logits)
        if int(cache["index"]) != s + n:
            raise AssertionError(f"decode: index {int(cache['index'])} != {s + n}")
        return torch.cat(outs, dim=1)  # positions s-1 .. s+n-1

    with torch.inference_mode():
        on_card = prefill_decode(params, tokens.to(dev))
        forward_card = fns.forward(params, {"tokens": tokens.to(dev)})[:, s - 1 :]
        with kernel_plain_attend():
            on_cpu = prefill_decode(tree_map(lambda t: t.cpu(), params), tokens)
    if on_card.shape != (b, n + 1, cfg.vocab_size) or not torch.isfinite(on_card.float()).all():
        raise AssertionError(f"decode: logits {tuple(on_card.shape)} not finite / wrong shape")
    on_card = on_card.cpu()
    err = max_err(torch, on_card, on_cpu)
    forward_card = forward_card.cpu()
    torch.testing.assert_close(on_card.float(), forward_card.float(), rtol=DECODE_TOL, atol=DECODE_TOL)
    err_fwd = float((on_card.float() - forward_card.float()).abs().max())
    log(f"decode qwen3-1.7b full width, 2 layers, B={b}, prefill {s} + {n} steps "
        f"({time.perf_counter() - t0:.1f} s):")
    log(f"  card kernels vs CPU plain kernels: max abs err {err:.3e} (rtol=atol={TOL})")
    log(f"  card decode vs card forward: max abs err {err_fwd:.3e} (rtol=atol={DECODE_TOL})")
    return {"err": err, "err_forward": err_fwd}


def serve_slice(torch, dev):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
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
    paged_attention.launches = 0
    for i in range(REQUESTS_PER_MODEL * len(tasks)):
        server.submit(Request(model=i % len(tasks), arrival_s=time.perf_counter()))
    t0 = time.perf_counter()
    stats = server.serve(wall_budget_s=600.0)
    serve_s = time.perf_counter() - t0
    launches = {"stream_matmul": stream_matmul.launches, "flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}
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
    # 197 and 28 a step at the published depth of both models; the live step
    # is a forward, so no paged_attention
    want = {
        "stream_matmul": sum((7 * t.cfg.num_layers + 1) * ls.steps[t.task_id] for t in tasks),
        "flash_attention": sum(t.cfg.num_layers * ls.steps[t.task_id] for t in tasks),
        "paged_attention": 0,
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
        profile_steps(torch, dev, t.cfg.name, t.run_step, statistics.median(step_s[t.task_id]))
    return launches, steps


def profile_steps(torch, dev, name: str, step, step_wall_s: float, n: int = 3) -> None:
    """Device time of ``n`` calls ``step(i)`` from torch.profiler, against
    the median step wall time of the timed run (taken without the profiler,
    whose own host cost would inflate the wall): the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6 / n
    if busy_s == 0:
        log(f"profile: {name} device time not measured (the profiler saw no kernel)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    log(f"profile: {name} device busy {1e3 * busy_s:.3f} ms a step; of a "
        f"{1e3 * step_wall_s:.3f} ms step the device idles {100 * (1 - busy_s / step_wall_s):.1f}%; "
        "top kernels (ms a step): " + ", ".join(
            f"{e.key[:48]} {e.self_device_time_total * 1e-3 / n:.3f}" for e in top))


def decode_slice(torch, dev):
    """Phase 6, the decode path of both models at their published widths and
    depths, random weights from a seed. Returns each path's launches and
    steps: {"prefill": (launches, prefills), "decode": (launches, steps)}."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import flatten
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    counted = {"stream_matmul": stream_matmul, "flash_attention": flash_attention,
               "paged_attention": paged_attention}

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    paths = {"prefill": ({name: 0 for name in counted}, 0), "decode": ({name: 0 for name in counted}, 0)}

    def add(path, launches):
        total, n = paths[path]
        paths[path] = ({k: total[k] + launches[k] for k in total}, n + 1)

    for seed, arch in enumerate(ARCHS):
        cfg = get_config(arch)
        L, hd = cfg.num_layers, cfg.resolved_head_dim()
        fns = build_model(cfg)
        prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
        with torch.inference_mode():
            params = fns.init(torch.Generator(dev).manual_seed(seed))
            prompts = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT), device=dev,
                                    generator=torch.Generator(dev).manual_seed(100 + seed))
            torch.cuda.synchronize(dev)
            zero()
            t0 = time.perf_counter()
            logits, cache = prefill_step(params, {"tokens": prompts}, max_seq=DECODE_SMAX)
            torch.cuda.synchronize(dev)
            prefill_s = time.perf_counter() - t0
            launches = read()
            want = {"stream_matmul": 7 * L + 1, "flash_attention": L, "paged_attention": 0}
            if launches != want:
                raise AssertionError(f"{arch} prefill: launches {launches} != {want}")
            add("prefill", launches)

            want = {"stream_matmul": 7 * L + 1, "flash_attention": 0, "paged_attention": L}
            outs, fed, step_s = [logits], [], []
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(DECODE_STEPS):
                zero()
                t0 = time.perf_counter()
                logits, cache = serve_step(params, cache, {"tokens": tok})
                torch.cuda.synchronize(dev)
                step_s.append(time.perf_counter() - t0)
                launches = read()
                if launches != want:
                    raise AssertionError(f"{arch} decode step {i}: launches {launches} != {want}")
                add("decode", launches)
                fed.append(tok)
                outs.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            if int(cache["index"]) != DECODE_SMAX:
                raise AssertionError(f"{arch}: index {int(cache['index'])} != {DECODE_SMAX}")

            decoded = torch.cat(outs, dim=1).float()  # positions PROMPT-1 .. DECODE_SMAX-1
            if not torch.isfinite(decoded).all():
                raise AssertionError(f"{arch}: decode logits not finite")
            t0 = time.perf_counter()
            full = fns.forward(params, {"tokens": torch.cat([prompts] + fed, dim=1)})
            ref = full[:, PROMPT - 1 :].float()
            del full
            forward_s = time.perf_counter() - t0
            rel = float((decoded - ref).norm() / ref.norm())
            per_step = ((decoded - ref).norm(dim=(0, 2)) / ref.norm(dim=(0, 2))).tolist()
            del decoded, ref

            leaves = flatten(params)
            elem = cache["k"].element_size()
            weight_bytes = sum(t.nbytes for p, t in leaves if p != "head/embed")
            weight_bytes += DECODE_B * cfg.d_model * elem  # the embedding rows a step reads
            kv_row = 2 * L * cfg.num_kv_heads * hd * elem  # K and V of one token, every layer
            med = statistics.median(step_s)
            med_len = statistics.median(range(PROMPT + 1, DECODE_SMAX + 1))
            step_bytes = weight_bytes + kv_row * DECODE_B * (med_len + 1)  # reads, then the new slot
            kv_bytes = cache["k"].nbytes + cache["v"].nbytes
            log(f"decode slice {arch}: B={DECODE_B}, prompt {PROMPT}, {DECODE_STEPS} greedy steps, "
                f"cache {DECODE_SMAX} slots, KV cache {kv_bytes} B")
            log(f"  prefill {1e3 * prefill_s:.3f} ms, {DECODE_B * PROMPT / prefill_s:.1f} tokens/s")
            log(f"  decode step median {1e3 * med:.3f} ms (min {1e3 * min(step_s):.3f}, max "
                f"{1e3 * max(step_s):.3f}), bound {1e3 * step_bytes / HBM_BYTES_PER_S:.3f} ms "
                f"({weight_bytes} B weights + {kv_row * DECODE_B * (med_len + 1):.0f} B KV at length {med_len}); "
                f"{DECODE_B / med:.1f} tokens/s at the median, {DECODE_B * DECODE_STEPS / sum(step_s):.1f} "
                f"over the {DECODE_STEPS} steps")
            log(f"  decode vs forward over the same {DECODE_SMAX} tokens ({1e3 * forward_s:.0f} ms): "
                f"relative L2 {rel:.3e} (gate {DECODE_REL_L2}); per position max "
                f"{max(per_step):.3e}, first {per_step[0]:.3e}, last {per_step[-1]:.3e}")
            if not rel <= DECODE_REL_L2:
                raise AssertionError(f"{arch}: decode vs forward relative L2 {rel:.3e} > {DECODE_REL_L2}")

            # 3 steps under the profiler: rewind the cache by 3 slots and feed
            # the last 3 tokens again (the same k/v land in the same slots)
            cache["index"] = torch.tensor(DECODE_SMAX - 3, dtype=torch.int32, device=dev)
            cache["host_index"] = DECODE_SMAX - 3
            state = {"cache": cache}

            def step(i):
                tokens = fed[DECODE_STEPS - 3 + i]
                _, state["cache"] = serve_step(params, state["cache"], {"tokens": tokens})

            profile_steps(torch, dev, f"{arch} decode", step, med)
            del params, cache, state, outs, fed, logits
        torch.cuda.empty_cache()
    return paths


if __name__ == "__main__":
    main()
