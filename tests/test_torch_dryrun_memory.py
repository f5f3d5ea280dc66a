"""The dry-run's memory pass (``roofline/memory.py``, ``launch/dryrun.py``)
on the CPU.

* Its count on meta, with the kernels' plain versions, equals byte for byte
  the same count over the real CPU step (every storage an op makes, while
  it lives): the train step of each family with remat off and on, with
  microbatches, and prefill and decode.
* With the kernels' CUDA paths (``card=True``) a reduced dense model at the
  flash kernel's tensor-core shapes makes exactly the storages the card's
  wrappers allocate: each flash call's output and ``lse2``, each flash
  backward's work buffer, the paged decode's split buffer, and nothing for
  the gemv products, whose K splits meet in a cluster (a MoE decode step's
  router and expert products too); and the remat residuals and f32 logits
  are the hand-computed sizes.
* An MoE router in f32 under autograd (the narrow route) makes the split-K
  workspace of its product and of its dW, and none for its dX.
* Under the pass a CPU tensor still takes the plain version, and the pass
  selects the CUDA path's account only for meta tensors.
* qwen3-1.7b's ``train_4k`` on one card does not fit: its f32 logits alone
  are 256 x 4096 x 151,936 x 4 B.

The sharded step's count on gloo ranks against the dry-run's:
``tests/test_torch_fsdp.py::test_one_layer_gathered_at_a_time``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels.flash_attention.ops import fa_bwd_row_chunks, fa_route, flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ops import pa_splits  # noqa: E402
from repro_torch.kernels.streammm.ops import k_splits, mm_route, narrow_splits, stream_matmul  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.launch.specs import make_concrete_batch  # noqa: E402
from repro_torch.launch.steps import make_train_state, make_train_step  # noqa: E402
from repro_torch.models.common import SHAPES_ONLY  # noqa: E402
from repro_torch.models.layers import kv_page_tokens, moe_capacity  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.roofline import memory  # noqa: E402

SHAPE = ShapeSpec("t", 64, 2, "train")
FAMILIES = {"dense": "qwen3-1.7b", "moe": "grok-1-314b", "ssm": "mamba2-1.3b", "hybrid": "recurrentgemma-9b",
            "vlm": "qwen2-vl-7b", "audio": "hubert-xlarge"}
ONE = parse_mesh("1x1")


def meta_batch(cfg, shape):
    return dryrun._local_batch(cfg, shape, ONE)[1]


def cpu_train_count(cfg, shape):
    state = make_train_state(cfg, torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, shape, seed=0, device="cpu")
    return memory.count(make_train_step(cfg), state, batch)[1]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_count_is_the_cpu_steps(family, remat):
    cfg = dataclasses.replace(get_config(FAMILIES[family]).reduced(), remat=remat)
    got = dryrun.train_memory(cfg, ONE, meta_batch(cfg, SHAPE), card=False)
    assert got == cpu_train_count(cfg, SHAPE)
    assert got.peak > 0 and got.breakdown["gradients"] + got.breakdown["optimizer"] + got.breakdown["layer"] > 0
    assert (got.held["residuals"] > 0) == remat


def test_microbatches_are_counted(monkeypatch):
    """``REPRO_MICROBATCH`` as the step reads it: the f32 accumulators of
    two microbatches, on meta as on the CPU."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), remat=True)
    one = dryrun.train_memory(cfg, ONE, meta_batch(cfg, SHAPE), card=False)
    monkeypatch.setenv("REPRO_MICROBATCH", "2")
    two = dryrun.train_memory(cfg, ONE, meta_batch(cfg, SHAPE), card=False)
    assert two == cpu_train_count(cfg, SHAPE)
    assert two.made != one.made


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_serving_meta_count_is_the_cpu_steps(family):
    cfg = get_config(FAMILIES[family]).reduced()
    fns = build_model(cfg)
    cpu = fns.init(torch.Generator().manual_seed(0))
    meta = fns.init(SHAPES_ONLY)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    (_, cache), got = memory.count(fns.prefill, cpu, {"tokens": tokens}, max_seq=48)
    _, want = memory.count(fns.prefill, meta, {"tokens": tokens.to("meta")}, max_seq=48)
    assert got == want and got.output > 0
    step = {"tokens": tokens[:, :1]}
    _, got = memory.count(fns.decode_step, cpu, cache, step)
    meta_cache = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
    _, want = memory.count(fns.decode_step, meta, meta_cache, {"tokens": step["tokens"].to("meta")})
    assert got == want


# a reduced dense model at the flash kernel's tensor-core shapes: bf16, head
# dim 64, S x H / Hkv = 128 folded rows (fa_route's "wgmma", which saves lse2)
DENSE = dict(head_dim=64, num_heads=4, num_kv_heads=2, vocab_size=1024, dtype="bfloat16")


@pytest.mark.parametrize("remat", [False, True])
def test_kernel_account_is_the_cards_allocations(remat):
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), remat=remat, **DENSE)
    b, s, d, n_layers, h, hd = SHAPE.global_batch, SHAPE.seq_len, cfg.d_model, cfg.num_layers, 4, 64
    got = dryrun.train_memory(cfg, ONE, meta_batch(cfg, SHAPE))
    out, lse2 = b * s * h * hd * 2, b * h * s * 4
    calls = n_layers * (1 + remat)  # remat's replay runs each layer's forward again
    assert got.made["attention"] == {out: calls, lse2: calls}
    assert got.held["attention"] == (1 if remat else n_layers) * (out + lse2)
    assert got.made["workspace"] == {2 * b * h * s * 4: n_layers}  # each backward's delta and lse2 rows
    assert got.made["logits"][b * s * cfg.vocab_size * 4] >= 1  # the f32 logits
    # remat keeps each layer's input (B, S, d) and the positions 0..S-1 (int32)
    assert got.held["residuals"] == (n_layers * b * s * d * 2 + s * 4 if remat else 0)
    plain = dryrun.train_memory(cfg, ONE, meta_batch(cfg, SHAPE), card=False)
    assert not plain.made["attention"] and not plain.made["workspace"]
    assert got.peak < plain.peak  # the plain attention's (B, Hkv, g, S, S) f32 scores


def test_paged_decode_counts_its_split_buffer():
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), **DENSE)
    fns = build_model(cfg)
    b, smax = 2, 4096
    cache = fns.init_cache(b, smax, "meta")
    cache["host_index"] = 100
    _, got = memory.count(fns.decode_step, fns.init(SHAPES_ONLY),
                          cache, {"tokens": torch.zeros((b, 1), dtype=torch.int32, device="meta")}, card=True)
    splits = pa_splits(b, cfg.num_kv_heads, smax // kv_page_tokens(smax), 132)
    assert splits > 1
    # and nothing for the gemv products (M = b rows), the layers' seven
    # projections and the LM head, though their K is split: the splits meet
    # in a thread-block cluster, with no workspace
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    products = [(d, 4 * 64), (d, 2 * 64), (d, 2 * 64), (4 * 64, d), (d, f), (d, f), (f, d)]
    assert all(mm_route(b, n, k, torch.bfloat16, True) == "gemv" for k, n in products + [(d, v)])
    assert max(k_splits(b, n, k, 132) for k, n in products + [(d, v)]) > 1
    assert got.made["workspace"] == {b * 4 * splits * (64 + 2) * 4: cfg.num_layers}


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_decode_expert_gemv_makes_no_workspace(arch):
    """A MoE decode step on meta with the card's paths: the f32 router at M =
    b and the three expert products at the decode's capacity take the gemv
    route (the experts' K splits counted over min(E, top_k x b) experts) and
    allocate nothing beside their outputs; the step's only work buffer is
    the paged decode's split buffer."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, **DENSE, moe=dataclasses.replace(cfg.moe, num_experts=16))
    fns = build_model(cfg)
    b, smax = 2, 4096
    cache = fns.init_cache(b, smax, "meta")
    cache["host_index"] = 100
    _, got = memory.count(fns.decode_step, fns.init(SHAPES_ONLY),
                          cache, {"tokens": torch.zeros((b, 1), dtype=torch.int32, device="meta")}, card=True)
    m, d = cfg.moe, cfg.d_model
    cap = moe_capacity(m, b)
    assert cap <= 8 and mm_route(cap, m.d_ff, d, torch.bfloat16, True) == "gemv"
    assert mm_route(b, m.num_experts, d, torch.float32, True) == "gemv"
    assert k_splits(cap, d, m.d_ff, 132, experts=min(m.num_experts, m.top_k * b)) > 1
    splits = pa_splits(b, cfg.num_kv_heads, smax // kv_page_tokens(smax), 132)
    attn_layers = sum(kind == "attn" for kind in cfg.layer_kinds()) if cfg.family == "hybrid" else cfg.num_layers
    want = {b * cfg.num_heads * splits * (64 + 2) * 4: attn_layers} if splits > 1 else {}
    assert got.made["workspace"] == want


def test_cpu_tensors_take_the_plain_version_under_the_pass():
    q, k, v = (torch.randn(1, 16, 2, 64, generator=torch.Generator().manual_seed(i)) for i in range(3))
    before = flash_attention.launches
    out, got = memory.count(flash_attention, q, k, v, card=True)
    assert torch.equal(out, flash_attention(q, k, v)) and flash_attention.launches == before
    assert not got.made["attention"] and got.peak > out.numel() * 4  # the plain version's scores
    meta = [t.to("meta") for t in (q, k, v)]
    assert not memory.count(flash_attention, *meta)[1].made["attention"]  # meta outside the card's account
    assert memory.count(flash_attention, *meta, card=True)[1].made["attention"] == {16 * 2 * 64 * 4: 1}
    assert not memory.card_shapes()


# hubert-xlarge's head dim 80 (MHA) and recurrentgemma-9b's 256 (MQA, g =
# 16) on the tensor-core route, and f32 at the same shapes on simt
NEW_HEAD_DIMS = [(80, 16, 16, torch.bfloat16, "wgmma"), (256, 16, 1, torch.bfloat16, "wgmma"),
                 (80, 16, 16, torch.float32, "simt"), (256, 16, 1, torch.float32, "simt")]


@pytest.mark.parametrize("d,h,hkv,dtype,route", NEW_HEAD_DIMS)
def test_flash_call_under_autograd_counts_statistics_and_workspace(d, h, hkv, dtype, route):
    """One flash call and its backward on meta with the card's paths: the
    wgmma route's forward makes its output and the rows' statistics (B, H,
    Sq) f32, its backward a 2-row workspace (lse2 and delta) and, at D =
    256, the row chunks' f32 partial dK and dV (fa_bwd_row_chunks: 4 here,
    two key blocks); the simt route makes no statistics and a 3-row
    workspace (m, l, delta)."""
    b, s = 2, 64
    q = torch.empty((b, s, h, d), dtype=dtype, device="meta", requires_grad=True)
    k, v = (torch.empty((b, s, hkv, d), dtype=dtype, device="meta", requires_grad=True) for _ in range(2))
    assert fa_route(b, s, s, h, hkv, d, dtype) == route

    def step(q, k, v):
        out = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    grads, got = memory.count(step, q, k, v, card=True)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    out_bytes, stats_bytes = q.numel() * q.element_size(), b * h * s * 4
    if route == "wgmma":
        chunks = fa_bwd_row_chunks(b, s, hkv, d, route)
        assert chunks == (4 if d == 256 else 1)
        assert got.made["attention"] == {out_bytes: 1, stats_bytes: 1}
        parts = {chunks * 2 * k.numel() * 4: 1} if chunks > 1 else {}
        assert got.made["workspace"] == {2 * stats_bytes: 1, **parts}
    else:
        assert got.made["attention"] == {out_bytes: 1}
        assert got.made["workspace"] == {3 * stats_bytes: 1}


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_f32_router_under_autograd_counts_its_split_workspace(arch):
    """The router's x (4096, d) @ w (d, E) in f32 and its backward on meta
    with the card's paths: the product and its dW (x read as (K, M), a d x E
    output) take the narrow route with K cut across blocks, each making a
    (splits, M, N) f32 workspace, marked as such; the dX (K = E) fills the
    card with its own tiles and makes none."""
    cfg = get_config(arch)
    m, d, e = 4096, cfg.d_model, cfg.moe.num_experts
    x = torch.empty((m, d), device="meta", requires_grad=True)
    w = torch.empty((d, e), device="meta", requires_grad=True)
    assert mm_route(m, e, d, torch.float32, True) == "narrow"
    assert mm_route(d, e, m, torch.float32, True, "kn", "km") == "narrow"
    assert mm_route(m, d, e, torch.float32, True, "nk") == "narrow"

    def step(x, w):
        y = stream_matmul(x, w, out_dtype=torch.float32)
        return torch.autograd.grad(y, (x, w), torch.ones_like(y))

    grads, got = memory.count(step, x, w, card=True)
    assert [g.shape for g in grads] == [x.shape, w.shape]
    fwd, dw = narrow_splits(m, e, d, 132), narrow_splits(d, e, m, 132)
    assert fwd > 1 and dw > 1 and narrow_splits(m, d, e, 132, w_layout="nk") == 1
    want = {}
    for parts, rows in ((fwd, m), (dw, d)):
        want[parts * rows * e * 4] = want.get(parts * rows * e * 4, 0) + 1
    assert got.made["workspace"] == want


def test_train_4k_on_one_card_does_not_fit():
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", "1x1")
    assert rec["status"] == "ok" and rec["fits_h100"] is False
    logits = 256 * 4096 * 151_936 * 4
    assert rec["mem"]["temp_breakdown"]["logits"] >= logits
    assert sum(rec["mem"]["temp_breakdown"].values()) == rec["mem"]["temp_bytes"]
    cfg = get_config("qwen3-1.7b")
    got = dryrun.train_memory(cfg, ONE, dryrun._local_batch(cfg, dryrun.SHAPES["train_4k"], ONE)[1])
    assert got.made["logits"][logits] >= 1 and got.peak == rec["mem"]["temp_bytes"]
