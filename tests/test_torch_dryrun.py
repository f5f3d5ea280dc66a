"""The port's dry-run (``repro_torch.launch.dryrun``, ``roofline/costs.py``)
on the CPU.

Its products' FLOPs for a reduced train cell of each family (dense, MoE,
SSM, hybrid, VLM, audio) on one device agree with
``analyze_hlo(jit(make_train_step).lower(...).compile().as_text()).dot_flops``
of the JAX package within 2%. They are equal for five families. The SSM's
differ by 1.55% (1.30% with remat): the chunked scan's three- and four-operand einsums
(``bijh,bjh,bjhp->bihp``, ``bis,bih,bhps->bihp``,
``bjs,bjh,bjh,bjhp->bhps``) contract in another order under
``torch.einsum`` than under XLA, which moves an elementwise factor into or
out of a product; that is the only difference allowed. Each cell runs with
remat off (the reduced configs') and on (the published configs'): with
remat, both replay a layer's forward in its backward but for the last
product, whose output the backward does not need (XLA removes it as dead
code; PyTorch's checkpoint stops its replay once every saved tensor is
back).

Also: the depth extrapolation equals a direct count, the per-device bytes
are those of the real state, the collective plan is the sharded step's
(one layer gathered at a time, its gradients reduce-scattered or
all-reduced as its backward ends, the products split over ``model`` and
their activations summed and gathered over it), the products a device
computes on (1, 4) are a quarter of the 1x1 count as under the reference's
GSPMD (the SSM and hybrid on 1x4, 2x2 and the pod meshes too, in training,
prefill and decode: the SSM's decode and the hybrid's differ from the
reference's at 1x1 by the conv's taps, which XLA counts as a dot), and
``main`` writes every cell of an arch on the three meshes. ``temp_bytes`` against what the step holds on
gloo ranks: ``tests/test_torch_fsdp.py``."""
import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.specs import batch_spec as ref_batch_spec  # noqa: E402
from repro.roofline.hlo_costs import analyze_hlo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import make_train_state  # noqa: E402
from repro_torch.roofline.costs import depth_flops  # noqa: E402
from repro_torch.sharding.specs import state_shardings  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

S, B = 64, 2
# family -> (arch, the largest relative difference allowed, its cause)
FAMILIES = {
    "dense": ("qwen3-1.7b", 0.0, None),
    "moe": ("grok-1-314b", 0.0, None),
    "ssm": ("mamba2-1.3b", 0.02, "multi-operand einsums contracted in another order"),
    "hybrid": ("recurrentgemma-9b", 0.0, None),
    "vlm": ("qwen2-vl-7b", 0.0, None),
    "audio": ("hubert-xlarge", 0.0, None),
}


def port_flops(cfg, shape, mesh="1x1"):
    return depth_flops(cfg, dryrun.build_cell(cfg, shape, mesh).count)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dot_flops_match_the_reference_hlo(family, remat):
    arch, allowed, _cause = FAMILIES[family]
    rcfg = dataclasses.replace(ref_config(arch).reduced(), remat=remat)
    state = ref_steps.abstract_train_state(rcfg)
    batch = ref_batch_spec(rcfg, RefShape("t", S, B, "train"))
    hlo = jax.jit(ref_steps.make_train_step(rcfg)).lower(state, batch).compile().as_text()
    want = analyze_hlo(hlo).dot_flops
    got = port_flops(dataclasses.replace(get_config(arch).reduced(), remat=remat), ShapeSpec("t", S, B, "train"))
    assert want > 0
    assert abs(got - want) <= allowed * want, (got, want, got / want)


@pytest.mark.parametrize("arch, layers", [("qwen3-1.7b", 5), ("recurrentgemma-9b", 8), ("mamba2-1.3b", 3)])
def test_depth_extrapolation_equals_a_direct_count(arch, layers):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    shape = ShapeSpec("t", 32, 2, "train")
    cell = dryrun.build_cell(cfg, shape, "1x1")
    assert depth_flops(cfg, cell.count) == cell.count(cfg)


def test_state_bytes_are_the_real_state_and_the_plan_the_sharded_step():
    cfg = get_config("qwen3-1.7b").reduced()
    shape = ShapeSpec("t", 64, 4, "train")
    state = make_train_state(cfg, torch.Generator().manual_seed(0))
    whole = sum(t.numel() * t.element_size() for _, t in flatten(state))
    assert dryrun.build_cell(cfg, shape, "1x1").mem["state_bytes"] == whole

    cell = dryrun.build_cell(cfg, shape, "2x4")
    specs = dict(flatten(state_shardings(cfg, state, cell.mesh)))
    shard = sum(torch.Size(specs[p].shard_shape(tuple(t.shape))).numel() * t.element_size()
                for p, t in flatten(state))
    assert cell.mem["state_bytes"] == shard < whole
    params = [(p.rsplit("/", 1)[-1], specs["params/" + p], t) for p, t in flatten(state["params"])]
    costs = cell.plan.costs(0)
    # The batch of 4 splits over data = 2 (2 x 64 tokens a rank), the products
    # over model = 4. Each leaf that model splits is kept as the rank's model
    # shard: gathered over data where data splits it (the shard less its
    # half), its gradient reduce-scattered there or else all-reduced over
    # data (twice the shard); the per-head norms are gathered whole and their
    # gradients all-reduced over data and model; grad_norm all-reduces a
    # 4-byte sum over each axis that splits a leaf; the label count, loss
    # and ce one over data.
    ag = rs = ar = 0
    for name, s, t in params:
        axes = [a for d in range(t.dim()) for a in s.axes(d)]
        held = t.numel() * t.element_size() // (4 if "model" in axes else 1)
        if name in ("q_norm", "k_norm"):
            ar += 2 * 2 * held
        elif "data" in axes:
            ag += held - held // 2
            rs += held - held // 2
        else:
            ar += 2 * held
        ar += 2 * 4 * len(axes)
    # Activations, bf16 (2, 64, 128) a rank: per layer the attention's and the
    # MLP's parts summed forward and their inputs' gradients backward; the
    # embedding's rows summed, the head's input gradient; the cross-entropy's
    # max, sum of exponentials and label logit, f32 (2, 64); K and V: each
    # rank's 16 columns (half a KV head) all-gathered to 64, reduce-scattered
    # back.
    act, kv_part, kv_whole = 2 * 64 * 128 * 2, 2 * 64 * 16 * 2, 2 * 64 * 64 * 2
    ar += 2 * act * (4 * cfg.num_layers + 2) + 3 * 2 * (2 * 64 * 4) + 3 * 2 * 4
    ag += 2 * cfg.num_layers * (kv_whole - kv_part)
    rs += 2 * cfg.num_layers * (kv_whole - kv_part)
    assert costs.collective_bytes["all-gather"] == ag > 0
    assert costs.collective_bytes["reduce-scatter"] == rs > 0
    assert costs.collective_bytes["all-reduce"] == ar
    assert cell.rows == 2


def test_main_writes_every_cell_on_the_three_meshes(tmp_path):
    out = tmp_path / "dry.jsonl"
    records = dryrun.main(["--arch", "hubert-xlarge", "--meshes", ",".join(dryrun.MESHES), "--out", str(out)])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines == json.loads(json.dumps(records)) and len(lines) == 12
    ok = [r for r in lines if r["status"] == "ok"]
    assert {(r["shape"], r["mesh"]) for r in ok} == {(s, m) for s in ("train_4k", "prefill_32k")
                                                      for m in dryrun.MESHES}
    assert all(r["status"] == "skipped" for r in lines if r not in ok)
    for r in ok:
        assert {"mem", "cost_analysis", "hlo_costs", "model", "fits_h100"} <= set(r)
        assert r["hlo_costs"]["dot_flops"] > 0 and r["mem"]["argument_bytes"] > 0
    by_mesh = {r["mesh"]: r for r in ok if r["shape"] == "train_4k"}
    # 256 rows: 16 a device on 16x16, 8 on 2x16x16, all on the one card
    assert [by_mesh[m]["rows_per_device"] for m in dryrun.MESHES] == [16, 8, 256]
    # a device of 16x16 takes 16 rows and splits every product but the head's
    # over model's 16 ranks: hubert's 504 targets do not divide 16, so the
    # head (forward, dX and dW over 16 x 4096 rows) is whole on every rank
    cfg = get_config("hubert-xlarge")
    rows16 = depth_flops(cfg, dryrun.build_cell(cfg, "train_4k", "16x1").count)
    head = 6 * 16 * 4096 * cfg.d_model * cfg.vocab_size
    assert by_mesh["1x1"]["hlo_costs"]["dot_flops"] == 16 * rows16
    assert by_mesh["16x16"]["hlo_costs"]["dot_flops"] == head + (rows16 - head) / 16
    assert sum(by_mesh["1x1"]["hlo_costs"]["collective_bytes"].values()) == 0


_GSPMD = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.launch.specs import batch_spec
from repro.roofline.hlo_costs import analyze_hlo
from repro.sharding import specs as sh
from repro.sharding.act import use_activation_mesh

cfg = get_config(sys.argv[1]).reduced()
shape = ShapeSpec("t", int(sys.argv[2]), int(sys.argv[3]), "train")
out = {}
for name in sys.argv[4:]:
    mesh = make_mesh(tuple(int(n) for n in name.split("x")), ("data", "model"))
    bspec = batch_spec(cfg, shape)
    bshard = sh.batch_shardings(cfg, bspec, mesh)
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=bshard[k]) for k, v in bspec.items()}
    state = jax.eval_shape(lambda: steps.make_train_state(cfg, jax.random.PRNGKey(0)))
    pspecs = sh.param_shardings(cfg, state["params"], mesh)
    sspecs = {"params": pspecs, "opt": sh.opt_state_shardings(cfg, state["opt"], pspecs, mesh),
              "step": NamedSharding(mesh, P())}
    state = jax.tree.map(lambda l, s: jax.ShapeDtypeStruct(l.shape, l.dtype, sharding=s), state, sspecs)
    with use_activation_mesh(mesh):
        hlo = jax.jit(steps.make_train_step(cfg), donate_argnums=(0,)).lower(state, batch).compile().as_text()
    out[name] = analyze_hlo(hlo).dot_flops
print(json.dumps(out))
'''


def test_split_products_on_1x4_beside_the_reference_gspmd():
    """The reduced dense config on (1, 4), the batch whole on each device:
    the placements split every product over model (4 heads, 2 KV heads, an
    FFN of 256, a vocabulary of 512), so the port's dry-run gives a device
    exactly a quarter of its 1x1 products. The reference's
    ``jit(make_train_step)`` on 4 fake host devices (a subprocess: the
    device count is fixed at JAX's start) gives the same: its per-device
    ``analyze_hlo(...).dot_flops`` is a quarter of its 1x1 count, which is
    the port's."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _GSPMD, "qwen3-1.7b", str(S), str(2 * B), "1x1", "1x4"], env=env,
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = get_config("qwen3-1.7b").reduced()
    shape = ShapeSpec("t", S, 2 * B, "train")
    one, four = port_flops(cfg, shape), port_flops(cfg, shape, "1x4")
    print(f"products' FLOPs a device, reduced qwen3-1.7b, {2 * B} x {S} tokens: port 1x1 {one}, 1x4 {four}; "
          f"reference GSPMD 1x1 {ref['1x1']}, 1x4 {ref['1x4']}")
    assert ref["1x1"] == one > 0
    assert 4 * four == one == 4 * ref["1x4"]


_GSPMD_SERVE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.launch.specs import batch_spec
from repro.roofline.hlo_costs import analyze_hlo
from repro.sharding import specs as sh
from repro.sharding.act import use_activation_mesh


def placed(tree, shardings):
    return jax.tree.map(lambda l, s: jax.ShapeDtypeStruct(l.shape, l.dtype, sharding=s), tree, shardings)


cfg = get_config(sys.argv[1]).reduced()
s, b = int(sys.argv[2]), int(sys.argv[3])
out = {}
for name in sys.argv[4:]:
    dims = tuple(int(n) for n in name.split("x"))
    mesh = make_mesh(dims, ("data", "model") if len(dims) == 2 else ("pod", "data", "model"))
    params = jax.eval_shape(lambda: steps.make_train_state(cfg, jax.random.PRNGKey(0)))["params"]
    params = placed(params, sh.param_shardings(cfg, params, mesh))
    for kind in ("prefill", "decode"):
        bspec = batch_spec(cfg, ShapeSpec("t", s, b, kind))
        bshard = sh.batch_shardings(cfg, bspec, mesh)
        batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=bshard[k]) for k, v in bspec.items()}
        with use_activation_mesh(mesh):
            if kind == "prefill":
                lowered = jax.jit(steps.make_prefill_step(cfg)).lower(params, batch)
            else:
                cache = steps.abstract_cache(cfg, b, s)
                cache = placed(cache, sh.cache_shardings(cfg, cache, mesh, b))
                lowered = jax.jit(steps.make_serve_step(cfg), donate_argnums=(1,)).lower(params, cache, batch)
            out[f"{kind} {name}"] = analyze_hlo(lowered.compile().as_text()).dot_flops
print(json.dumps(out))
'''

# products' FLOPs a device of the reduced qwen3-1.7b's serving cells, B = 8,
# S = 256: the reference's GSPMD and the port on 1x1 / 1x4 / 2x2 / (pod,
# data, model) 2x1x2 / 2x2x1
SERVE_MESHES = ("1x1", "1x4", "2x2", "2x1x2", "2x2x1")
SERVE_GSPMD = {"prefill": (1_745_879_040, 436_469_760, 436_469_760, 436_469_760, 436_469_760),
               "decode": (7_864_320, 1_966_080, 1_966_080, 1_966_080, 2_555_904)}
SERVE_PORT = dict(SERVE_GSPMD, decode=(7_864_320, 1_966_080, 1_966_080, 1_966_080, 1_966_080))


def test_serving_products_beside_the_reference_gspmd():
    """The reduced dense config's prefill (8 x 256 tokens) and decode (8
    rows against 256 slots): the reference's ``jit(make_prefill_step)`` and
    ``jit(make_serve_step)`` over parameters placed by ``param_shardings``
    and a cache by ``cache_shardings``, on 4 fake host devices (a
    subprocess), count the products of a device at a quarter of 1x1 on
    (1, 4), (2, 2) and the pod meshes (pod 2 splits the rows as ``data``
    does), but for the decode on 2x2x1: there the tokens' (pod, data)
    runs do not lie in the cache's ``data`` runs, and GSPMD moves rows
    between them at 30% more products. The port's dry-run of its sharded
    serving steps counts exactly the reference's on each mesh, and a
    quarter on that one: its rank takes a run of its cache shard's rows
    (``launch.steps.serve_rows``)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _GSPMD_SERVE, "qwen3-1.7b", "256", "8", *SERVE_MESHES], env=env,
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = get_config("qwen3-1.7b").reduced()
    for kind, want in SERVE_GSPMD.items():
        port = [port_flops(cfg, ShapeSpec("t", 256, 8, kind), mesh) for mesh in SERVE_MESHES]
        gspmd = [ref[f"{kind} {mesh}"] for mesh in SERVE_MESHES]
        print(f"{kind}: products' FLOPs a device on {' / '.join(SERVE_MESHES)}: port {port}, reference GSPMD {gspmd}")
        assert tuple(gspmd) == want and tuple(port) == SERVE_PORT[kind]
        assert all(4 * n == port[0] for n in port[1:])


# products' FLOPs a device of the reduced mamba2-1.3b and recurrentgemma-9b
# under the reference's GSPMD: train 4 x 64 tokens on RECURRENT_MESHES,
# prefill 8 x 256 and decode of 8 rows against 256 slots on SERVE_MESHES
RECURRENT_MESHES = ("1x1", "1x4", "2x2")
RECURRENT_GSPMD = {
    "mamba2-1.3b": {"train": (474_480_640, 118_620_160, 118_620_160),
                    "prefill": (995_098_624, 248_774_656, 283_377_664, 248_774_656, 283_377_664),
                    "decode": (4_558_848, 1_139_712, 1_139_712, 1_139_712, 1_139_712)},
    "recurrentgemma-9b": {"train": (893_386_752, 223_346_688, 223_346_688),
                          "prefill": (2_316_304_384, 579_076_096, 679_739_392, 579_076_096, 679_739_392),
                          "decode": (9_125_888, 2_281_472, 2_281_472, 2_281_472, 2_891_776)},
}
# the port's 1x1 count less the reference's: the SSM's multi-operand einsums
# in training (module docstring); in decode, the conv's 4 taps over its
# channels for 8 rows, 2 FLOPs each, every recurrent layer (the reference
# contracts them in one einsum, which XLA counts as a dot; the port sums the
# taps elementwise): mamba2 2 layers x 288 channels, the hybrid 2 x 128
RECURRENT_1X1 = {"mamba2-1.3b": {"train": 467_140_608 - 474_480_640, "prefill": 0, "decode": -2 * 8 * 4 * 288 * 2},
                 "recurrentgemma-9b": {"train": 0, "prefill": 0, "decode": -2 * 8 * 4 * 128 * 2}}


def test_recurrent_products_beside_the_reference_gspmd():
    """The reduced SSM and hybrid configs split over ``model`` as the
    reference's GSPMD splits them (``models/ssm.py``, ``models/rglru.py``).
    GSPMD's per-device products (``analyze_hlo`` of ``jit(make_train_step)``,
    ``jit(make_prefill_step)`` and ``jit(make_serve_step)`` on 4 fake host
    devices, subprocesses) are a quarter of its 1x1 count on every mesh
    but prefill on 2x2 and 2x2x1 (13.9% and 17.4% above: it moves rows, as
    in the dense decode on 2x2x1) and the hybrid's decode on 2x2x1. The
    port's dry-run: the hybrid exactly a quarter of its 1x1 count on every
    mesh and step; the SSM a quarter but for ``C Bᵀ`` (the chunked scan's
    ``bis,bjs->bij``, B x S x Q x state_dim a layer, 2 FLOPs each, three
    times in training: forward, dB, dC), which every rank computes whole
    for the heads it holds, within 2%. At 1x1 the port counts the
    reference's products but for RECURRENT_1X1."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("XLA_FLAGS", None)
    runs = {(arch, script): subprocess.Popen(
        [sys.executable, "-c", script, arch, *(("64", "4", *RECURRENT_MESHES) if script is _GSPMD
                                               else ("256", "8", *SERVE_MESHES))],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in RECURRENT_GSPMD for script in (_GSPMD, _GSPMD_SERVE)}
    port = {}
    for arch in RECURRENT_GSPMD:
        cfg = get_config(arch).reduced()
        port[arch] = {"train": [port_flops(cfg, ShapeSpec("t", 64, 4, "train"), m) for m in RECURRENT_MESHES]}
        for kind in ("prefill", "decode"):
            port[arch][kind] = [port_flops(cfg, ShapeSpec("t", 256, 8, kind), m) for m in SERVE_MESHES]
    for (arch, script), run in runs.items():
        out, err = run.communicate(timeout=600)
        assert run.returncode == 0, err[-3000:]
        ref = json.loads(out.strip().splitlines()[-1])
        if script is _GSPMD:
            assert tuple(ref[m] for m in RECURRENT_MESHES) == RECURRENT_GSPMD[arch]["train"], (arch, ref)
        else:
            for kind in ("prefill", "decode"):
                assert tuple(ref[f"{kind} {m}"] for m in SERVE_MESHES) == RECURRENT_GSPMD[arch][kind], (arch, ref)
    for arch, kinds in port.items():
        cfg = get_config(arch).reduced()
        for kind, counts in kinds.items():
            meshes = RECURRENT_MESHES if kind == "train" else SERVE_MESHES
            print(f"{arch} {kind}: products' FLOPs a device on {' / '.join(meshes)}: port {counts}, reference "
                  f"GSPMD {list(RECURRENT_GSPMD[arch][kind])}")
            assert counts[0] - RECURRENT_GSPMD[arch][kind][0] == RECURRENT_1X1[arch][kind], (arch, kind, counts)
            for mesh, n in zip(meshes[1:], counts[1:]):
                *pods, data, model = (int(x) for x in mesh.split("x"))
                excess = 0
                if cfg.family == "ssm" and kind != "decode":  # C B^T whole on each rank of model
                    s = cfg.ssm
                    b, seq = (4, 64) if kind == "train" else (8, 256)
                    cb = (3 if kind == "train" else 1) * 2 * b * seq * s.chunk * s.state_dim * cfg.num_layers
                    excess = cb * (model - 1) // (model * data * math.prod(pods))
                    assert (excess > 0) == (model > 1) and excess <= 0.02 * counts[0] / 4
                assert 4 * (n - excess) == counts[0], (arch, kind, mesh, n, counts[0], excess)


_SERVE_MEMORY = r'''
from repro_torch.launch import dryrun
from repro_torch.launch.specs import make_concrete_batch
from repro_torch.launch.steps import serve_split, shard_decode, shard_prefill
from repro_torch.roofline import memory
from repro_torch.sharding.specs import cache_shardings


def case_serve_memory(mesh, out):
    """One rank's real sharded prefill and decode, each under
    ``roofline.memory.count`` (the kernels' plain versions), beside the
    dry-run's count of the same cell on meta."""
    for arch in ("qwen3-1.7b", "grok-1-314b", "mamba2-1.3b", "recurrentgemma-9b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        fns = build_model(cfg)
        params = fns.init(torch.Generator().manual_seed(0))
        placed = place(params, param_shardings(cfg, params, mesh))
        shards = tree_map(local, placed)
        for kind in ("prefill", "decode"):
            shape = ShapeSpec("t", 64, 4, kind)
            batch = make_concrete_batch(cfg, shape, seed=1, device="cpu")
            whole = fns.init_cache(4, 64, "cpu")
            cspecs = cache_shardings(cfg, whole, mesh, 4)
            split = serve_split(cfg, mesh, placed, cspecs, batch)
            if kind == "prefill":
                _, held = memory.count(shard_prefill(cfg), shards, batch, split)
            else:
                cache = tree_map(local, place({k: whole[k] for k in cspecs}, cspecs))
                _, held = memory.count(shard_decode(cfg), shards, dict(cache, host_index=0), batch, split)
            counts = [None] * dist.get_world_size()
            dist.all_gather_object(counts, [held.peak, held.breakdown])
            mem = dryrun.build_cell(cfg, shape, mesh_shape(mesh), card=False).mem
            out[f"{arch} {kind}"] = {"counts": counts, "temp": mem["temp_bytes"],
                                     "breakdown": mem["temp_breakdown"]}
'''


@pytest.mark.parametrize("mesh", ["2x2", "2x1x2"])
def test_serving_temp_bytes_are_a_gloo_rank_s(tmp_path, mesh):
    """(2, 2) and (pod 2, data 1, model 2) gloo ranks: each rank's count of
    its real sharded prefill and decode (the reduced dense, grok, SSM and
    hybrid configs, f32, 4 rows, 64 slots (the hybrid's ring 16); on the
    pod mesh each rank computes 2 rows of a 4-row cache shard) is the
    dry-run's ``temp_bytes`` for that cell and mesh, and its bytes by kind
    at the peak the dry-run's ``temp_breakdown``, byte for byte."""
    from test_torch_distributed import _RANK, run_ranks

    head, main = _RANK.split('\nif __name__ == "__main__":')
    script = head + "\nfrom repro_torch.launch.mesh import mesh_shape\n" + _SERVE_MEMORY + \
        '\nif __name__ == "__main__":' + main
    out = run_ranks(tmp_path, "serve_memory", mesh, script_text=script)
    assert len(out) == 8
    for cell, rec in out.items():
        assert rec["temp"] > 0, (cell, rec)
        for peak, breakdown in rec["counts"]:
            assert peak == rec["temp"] and breakdown == rec["breakdown"], (cell, rec)
