"""The SSM and RG-LRU blocks split over ``model`` (``models/ssm.py``,
``models/rglru.py``, ``sharding/fsdp.tp_exchange``) in the sharded train
step and the sharded serving steps, on gloo ranks on the CPU, one process
a rank (``run_ranks`` of ``tests/test_torch_distributed.py``), one run a
mesh:

* (2, 2): 8 SSM heads a rank, its 280 columns of the 560 packed ``in_proj``
  columns (z | x | B | C | dt, which the exchange turns into its heads' z,
  x, dt and the whole of B and C); 64 RG-LRU channels, two query heads and
  half the one KV head of the hybrid's attention; a ring of 16 slots, 8 a
  rank;
* (1, 4): 4 heads and 140 columns; 32 channels, one query head; 4 slots;
* (1, 8): 2 heads and 70 columns (a run that cuts the x and B / C
  columns); 16 channels, half a query head; 2 slots.

The reduced mamba2-1.3b and recurrentgemma-9b (3 layers: one (rec, rec,
attn) group) in f32, and on (1, 4) the hybrid at 5 layers too (its two
trailing recurrent layers outside the group): 4 steps of the sharded train step
held to ``make_train_step`` within 1e-5 (losses, gradient norms, every
gradient at the parameters each step starts from) and each step's new
state within 1e-6 of the unsharded optimizer fed its gradients; then a
prefill of 4 x 29 tokens and 8 decode steps (indices 29-36) through the
sharded serving steps held to the meshless steps within 1e-5 (relative to
the largest value): the logits, each rank's cache shard after the prefill
and after the decode. The hybrid's ring of 16 slots wraps at index 32, and
every mesh's slices of it are crossed. No leaf that ``model`` splits is
all-gathered over it but the SSM's ``conv_w`` and ``conv_b`` (read whole
at the rank's channels, mode ``sum``; ``ModelGathers`` of
``tests/test_torch_tensor_parallel.py``).

On (pod 2, data 2, model 2) the serving steps, each rank computing one
row of a cache shard that the two ranks along ``pod`` share, within 1e-5.
On a one-rank mesh the sharded steps give the meshless bits. On (1, 4),
each config's loss, prefill and 4 decode steps agree with the JAX
package's within 1e-4, the reference computed in this process."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import run_ranks  # noqa: E402
from test_torch_tensor_parallel import _CASES as _TP  # noqa: E402

_HEAD, _MAIN = _TP.split('\nif __name__ == "__main__":')

_CASES = _HEAD + r'''
import numpy as np
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_sharded_prefill_step, make_sharded_serve_step)
from repro_torch.models.convert import params_from_reference
from repro_torch.sharding.specs import cache_shardings
from repro_torch.tree import unflatten

RECURRENT = {"ssm": ("mamba2-1.3b", None), "hybrid": ("recurrentgemma-9b", None),
             "hybrid5": ("recurrentgemma-9b", 5)}
B, PROMPT, STEPS = 4, 29, 8


def recurrent_config(name):
    arch, layers = RECURRENT[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def close(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp(min=1e-30))


def worst(values):
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def serve_inputs(cfg, steps=STEPS, seed=3):
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, PROMPT)))
    toks = np.random.default_rng(seed + 1).integers(1, cfg.vocab_size, (steps, B, 1))
    return {"tokens": prompt}, [{"tokens": torch.from_numpy(t)} for t in toks]


def cache_rel(cfg, mesh, got, want):
    """The largest relative difference of the rank's cache shard ``got``
    (DTensors) from its cut of the meshless cache ``want``, leaf by leaf."""
    tensors = {k: v for k, v in want.items() if isinstance(v, torch.Tensor) and k != "index"}
    specs = cache_shardings(cfg, tensors, mesh, B)
    cut = place(tensors, {k: specs[k] for k in tensors})
    return max(close(got[k].to_local(), cut[k].to_local()) for k in tensors)


def serve_run(cfg, mesh, params):
    """The sharded serving steps against the meshless ones: (prefill logits,
    cache shard after the prefill, each decode step's logits, cache shard
    after them) relative differences, largest over the ranks; the rank's
    cache shapes."""
    coords = dict(zip(mesh_shape(mesh).axis_names, mesh.get_coordinate()))
    pods = mesh_shape(mesh).shape.get("pod", 1)
    placed = place(params, param_shardings(cfg, params, mesh))
    prompt, toks = serve_inputs(cfg)
    want, want_cache = make_prefill_step(cfg)(params, prompt)
    got, cache = make_sharded_prefill_step(cfg, mesh)(placed, prompt)
    rows = got.shape[0]
    r0 = (coords["data"] * pods + coords.get("pod", 0)) * rows  # run pod of its cache shard's rows
    errs = [close(got, want[r0 : r0 + rows]), cache_rel(cfg, mesh, cache, want_cache)]
    serve, plain = make_sharded_serve_step(cfg, mesh), make_serve_step(cfg)
    for tok in toks:
        want, want_cache = plain(params, want_cache, tok)
        got, cache = serve(placed, cache, tok)
        errs.append(close(got, want[r0 : r0 + rows]))
    assert cache["host_index"] == PROMPT + len(toks) == int(cache["index"].to_local())
    errs.append(cache_rel(cfg, mesh, cache, want_cache))
    shapes = {k: list(v.to_local().shape) for k, v in cache.items() if k not in ("index", "host_index")}
    return worst(errs), shapes


def case_recurrent(mesh, out, names):
    tracker = ModelGathers()
    for name in names.split(","):
        cfg = recurrent_config(name)
        tracker.seen.clear()
        data = batches(cfg, 4)
        _, got, got_norms, grad_rel, update_rel = checked_steps(cfg, mesh, data)
        # only rank 0's results are read: the other ranks skip the unsharded run
        _, want, want_norms = unsharded(cfg, data) if dist.get_rank() == 0 else (None, got, got_norms)
        train_leaves = dict(tracker.seen)
        tracker.seen.clear()
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        errs, shapes = serve_run(cfg, mesh, params)
        out[name] = {"loss_rel": rel(got, want), "norm_rel": rel(got_norms, want_norms), "grad_rel": grad_rel,
                     "update_rel": update_rel, "train_leaves": train_leaves, "serve_leaves": dict(tracker.seen),
                     "prefill_rel": errs[0], "cache_rel": max(errs[1], errs[-1]), "decode_rel": errs[2:-1],
                     "cache_shapes": shapes}


def case_pod(mesh, out):
    """(pod 2, data 2, model 2): the serving steps alone, each rank one row
    of a 2-row cache shard that the two ranks along ``pod`` share."""
    for name in ("ssm", "hybrid"):
        cfg = recurrent_config(name)
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        errs, shapes = serve_run(cfg, mesh, params)
        out[name] = {"prefill_rel": errs[0], "cache_rel": max(errs[1], errs[-1]), "decode_rel": errs[2:-1],
                     "cache_shapes": shapes}


def case_one(mesh, out):
    """(1, 1): the sharded steps' bits against the meshless steps'."""
    for name in ("ssm", "hybrid"):
        cfg = recurrent_config(name)
        st, got = run(cfg, mesh, 3)
        ref, want = run(cfg, None, 3)
        same = [got == want, max_rel_leaf(st["params"], ref["params"]) == 0.0]
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        placed = place(params, param_shardings(cfg, params, mesh))
        prompt, toks = serve_inputs(cfg)
        want, want_cache = make_prefill_step(cfg)(params, prompt)
        got, cache = make_sharded_prefill_step(cfg, mesh)(placed, prompt)
        same.append(torch.equal(got, want))
        for tok in toks:
            want, want_cache = make_serve_step(cfg)(params, want_cache, tok)
            got, cache = make_sharded_serve_step(cfg, mesh)(placed, cache, tok)
            same.append(torch.equal(got, want))
        same += [torch.equal(cache[k].to_local(), want_cache[k]) for k in want_cache if k not in ("index", "host_index")]
        out[name] = same


def case_reference(mesh, out, npz):
    """The reference's parameters and batch (an npz of flattened paths) for
    each recurrent config: the sharded train step's loss, the sharded
    prefill's and 4 decode steps' logits on ``mesh`` (rank 0's rows: all
    of them, as ``data`` is 1)."""
    data = np.load(npz)
    for name in ("ssm", "hybrid"):
        cfg = recurrent_config(name)
        params = params_from_reference(unflatten((k[len(name) + 1:], data[k]) for k in data.files
                                                 if k.startswith(name + "/params/")))["params"]
        placed = place(params, param_shardings(cfg, params, mesh))
        tokens = torch.from_numpy(data[name + "/tokens"]).long()
        batch = {"tokens": tokens[:, :-1], "labels": torch.from_numpy(data[name + "/labels"]).long()}
        loss, _, _ = value_and_grad(build_model(cfg), tree_map(local, placed), batch,
                                    sharded_split(cfg, mesh, placed, batch))
        logits, cache = make_sharded_prefill_step(cfg, mesh)(placed, {"tokens": tokens[:, :PROMPT]})
        got = [logits.tolist()]
        serve = make_sharded_serve_step(cfg, mesh)
        for i in range(4):
            logits, cache = serve(placed, cache, {"tokens": tokens[:, PROMPT + i : PROMPT + i + 1]})
            got.append(logits.tolist())
        out[name] = {"loss": float(loss), "logits": got}
''' + '\nif __name__ == "__main__":' + _MAIN

MESHES = ("2x2", "1x4", "1x8")
# the hybrid's trailing recurrent layers (5 layers) on (1, 4) alone
CASES = [(mesh, name) for mesh in MESHES for name in ("ssm", "hybrid", "hybrid5") if name != "hybrid5" or mesh == "1x4"]
_RUNS = {}


@pytest.fixture
def recurrent_run(request, tmp_path_factory):
    """(mesh, name, its results): one gloo run a mesh, of every name that
    CASES gives it."""
    mesh, name = request.param
    if mesh not in _RUNS:
        names = ",".join(n for m, n in CASES if m == mesh)
        _RUNS[mesh] = run_ranks(tmp_path_factory.mktemp("recurrent"), "recurrent", mesh, names, script_text=_CASES,
                                timeout=400)
    return mesh, name, _RUNS[mesh][name]


@pytest.mark.parametrize("recurrent_run", CASES, indirect=True, ids=[f"{m}-{n}" for m, n in CASES])
def test_split_train_step_equals_the_unsharded_step(recurrent_run):
    """4 f32 steps: losses and gradient norms within 1e-5 of the unsharded
    step's, every gradient leaf at the parameters each step starts from
    within 1e-5 of the unsharded gradient, each step's new state within
    1e-6 of the unsharded optimizer applied to the whole state it started
    from with the step's own gradients gathered."""
    mesh, name, out = recurrent_run
    assert out["loss_rel"] <= 1e-5 and out["norm_rel"] <= 1e-5, (mesh, out["loss_rel"], out["norm_rel"])
    assert max(out["grad_rel"].values()) <= 1e-5, (mesh, out["grad_rel"])
    assert out["update_rel"] <= 1e-6, (mesh, out["update_rel"])


@pytest.mark.parametrize("recurrent_run", CASES, indirect=True, ids=[f"{m}-{n}" for m, n in CASES])
def test_split_serving_equals_the_meshless_steps(recurrent_run):
    """Prefill logits and each rank's cache shard, then 8 decode steps'
    logits across the ring's wrap (index 32) and a rank's slice of it, and
    the cache shard after them, within 1e-5 of the meshless steps. Each
    rank holds 4 / data rows and, cut over ``model``, the SSM's heads and
    conv channels, the RG-LRU's channels and the ring's 16 slots."""
    mesh, name, out = recurrent_run
    data, model = (int(x) for x in mesh.split("x"))
    assert out["prefill_rel"] <= 1e-5 and out["cache_rel"] <= 1e-5, (mesh, out)
    assert len(out["decode_rel"]) == 8 and max(out["decode_rel"]) <= 1e-5, (mesh, out["decode_rel"])
    shapes = out["cache_shapes"]
    if name == "ssm":  # 16 heads; conv over 256 + 2 x 16 channels
        assert shapes["state"][1:3] == [4 // data, 16 // model] and shapes["conv"][1:] == [4 // data, 3, 288 // model]
    else:
        assert shapes["h"][1:] == [4 // data, 128 // model] and shapes["conv"][1:] == [4 // data, 3, 128 // model]
        assert shapes["k"][1:3] == [4 // data, 16 // model], (mesh, shapes)
        n = 16 // model
        slots = [i % 16 for i in range(28, 37)]
        assert len({s // n for s in slots}) > 1 and 0 in slots  # a rank's slice and the wrap are crossed


@pytest.mark.parametrize("recurrent_run", CASES, indirect=True, ids=[f"{m}-{n}" for m, n in CASES])
@pytest.mark.parametrize("path", ["train_leaves", "serve_leaves"])
def test_no_split_leaf_is_gathered_over_model(recurrent_run, path):
    """Every leaf that ``model`` splits is kept as the rank's shard and never
    all-gathered over it, but the SSM's ``conv_w`` and ``conv_b``: their
    channel runs do not line up with heads, so each rank reads them whole
    (mode ``sum``), 4 x 288 + 288 values a layer."""
    mesh, name, out = recurrent_run
    leaves = out[path]
    split = {p for p, s in leaves.items() if s["split"]}
    gathered = {p for p, s in leaves.items() if s["split"] and s["gathered"]}
    assert {p for p in split if leaves[p]["mode"] != "local"} == gathered, (mesh, leaves)
    if name == "ssm":
        assert gathered == {"mixer/conv_w", "mixer/conv_b"}, (mesh, gathered)
        assert {"mixer/in_proj", "mixer/out_proj", "mixer/A_log", "mixer/gate_norm"} <= split, (mesh, sorted(split))
    else:
        assert not gathered, (mesh, gathered)
        rec = {"rec/w_in", "rec/w_gate_branch", "rec/w_a", "rec/w_x", "rec/w_out", "rec/conv_w", "rec/lam"}
        attn = {"attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w1", "mlp/w2"}
        if path == "train_leaves":  # a remat group's tree: r0, r1, attn
            assert {"r0/" + p for p in rec} | {"attn/" + p for p in attn} <= split, (mesh, sorted(split))
        else:
            assert rec | attn <= split, (mesh, sorted(split))


def test_split_serving_on_a_pod_mesh(tmp_path):
    """(pod 2, data 2, model 2): each rank computes one row of its cache
    shard's two (``launch.steps.serve_rows``) and joins the new state, conv
    history and k / v rows of the rank along ``pod`` into it
    (``fsdp.share_all_gather``); the logits and the cache shard within 1e-5
    of the meshless steps'."""
    out = run_ranks(tmp_path, "pod", "2x2x2", script_text=_CASES, timeout=400)
    for name, rec in out.items():
        assert rec["prefill_rel"] <= 1e-5 and rec["cache_rel"] <= 1e-5, (name, rec)
        assert len(rec["decode_rel"]) == 8 and max(rec["decode_rel"]) <= 1e-5, (name, rec)
        assert all(shape[1] == 2 for shape in rec["cache_shapes"].values()), (name, rec["cache_shapes"])


def test_one_rank_mesh_gives_the_meshless_bits(tmp_path):
    """(1, 1): 3 sharded train steps give ``make_train_step``'s losses and
    parameters, the sharded prefill and 8 decode steps the meshless
    logits and cache, bit for bit."""
    out = run_ranks(tmp_path, "one", "1x1", script_text=_CASES)
    for name, same in out.items():
        assert all(same) and len(same) == 2 + 1 + 8 + (2 if name == "ssm" else 4), (name, same)


def test_split_recurrent_against_the_reference(tmp_path):
    """On (1, 4), the reduced mamba2-1.3b and recurrentgemma-9b in f32: the
    sharded train step's loss, the sharded prefill's logits (29 tokens)
    and 4 decode steps' against the JAX package's ``loss``, ``prefill`` and
    ``decode_step`` on the same parameters, within 1e-4."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models.model import build_model as ref_build
    from repro_torch.tree import flatten

    arrays, refs, want = {}, {}, {}
    for name, arch in (("ssm", "mamba2-1.3b"), ("hybrid", "recurrentgemma-9b")):
        cfg = dataclasses.replace(ref_config(arch).reduced(), dtype="float32")
        fns = ref_build(cfg)
        params = jax.tree.map(np.asarray, fns.init(jax.random.PRNGKey(7)))
        rng = np.random.default_rng(7)
        tokens = rng.integers(1, cfg.vocab_size, (4, 64 + 1)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        arrays.update({f"{name}/tokens": tokens, f"{name}/labels": labels},
                      **{f"{name}/params/" + p: a for p, a in flatten(params)})
        refs[name] = (cfg, fns, params, tokens, labels)
    npz = tmp_path / "reference.npz"
    np.savez(npz, **arrays)
    # the ranks run while this process computes the reference
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, tmp_path, "reference", "1x4", str(npz), script_text=_CASES)
        for name, (cfg, fns, params, tokens, labels) in refs.items():
            loss, _ = fns.loss(params, {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(labels)})
            logits, cache = fns.prefill(params, {"tokens": jnp.asarray(tokens[:, :29])})
            logits_all = [np.asarray(logits)]
            for i in range(4):
                logits, cache = fns.decode_step(params, cache, {"tokens": jnp.asarray(tokens[:, 29 + i : 30 + i])})
                logits_all.append(np.asarray(logits))
            want[name] = (float(loss), logits_all, cfg.vocab_size)
        got = ranks.result()
    for name, (loss, logits, vocab) in want.items():
        assert abs(got[name]["loss"] - loss) <= 1e-4 * abs(loss), (name, got[name]["loss"], loss)
        for step, (g, w) in enumerate(zip(got[name]["logits"], logits)):
            g = np.asarray(g, np.float64)
            assert g.shape == w.shape == (4, 1, vocab)
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (name, step, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("mesh", MESHES)
def test_kernels_cuda_paths_take_the_shard_shapes(mesh):
    """The dry-run's memory pass of each reduced recurrent config's train,
    prefill and decode cells on one rank of the mesh, with the kernels'
    CUDA paths up to the launch (meta tensors, ``card=True``): every
    kernel's checks (contiguity, shapes, dtypes, the route rules) pass at
    the shard shapes, the exchanged SSM projection and the hybrid's half a
    query head on (1, 8) among them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
        for kind in ("train", "prefill", "decode"):
            mem = dryrun.build_cell(cfg, ShapeSpec("t", 64, 8, kind), mesh, card=True).mem
            assert mem["temp_bytes"] > 0, (arch, kind, mem)


def test_ssd_gradients_stay_finite_past_f32s_range():
    """The SSD scan's intra-chunk decay exp(cum_i - cum_j) is masked to i >=
    j. The reference takes the exp of every (i, j) and masks after it, so
    where cum_i - cum_j for some i < j passes f32's range (a chunk of steps
    whose decays sum past 88, as at published widths and 256-step chunks)
    the masked inf's gradient is 0 * inf = NaN. The port masks before the
    exp: the same loss, and every gradient finite. The reduced mamba2-1.3b
    in f32 with ``dt_bias`` 10 (a decay of about 10 a step, 310 over a
    32-step chunk)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models.model import build_model as ref_build
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ref_config("mamba2-1.3b").reduced(), dtype="float32")
    fns = ref_build(cfg)
    params = jax.tree.map(np.asarray, fns.init(jax.random.PRNGKey(3)))
    params["layers"]["mixer"]["dt_bias"] = np.full_like(params["layers"]["mixer"]["dt_bias"], 10.0)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want, grads = jax.value_and_grad(lambda p: fns.loss(p, {"tokens": jnp.asarray(tokens),
                                                             "labels": jnp.asarray(labels)})[0])(params)
    assert not all(bool(np.isfinite(np.asarray(g)).all()) for g in jax.tree.leaves(grads))
    port = dataclasses.replace(get_config("mamba2-1.3b").reduced(), dtype="float32")
    loss, _, got = value_and_grad(build_model(port), params_from_reference(params),
                                  {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()})
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want)), (float(loss), float(want))
    assert all(bool(torch.isfinite(g).all()) for g in got)
