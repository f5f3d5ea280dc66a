"""The sharded serving steps (``launch/steps.make_sharded_prefill_step``
and ``make_sharded_serve_step``) on gloo ranks on the CPU, one process a
rank (``run_ranks`` of ``tests/test_torch_distributed.py``), one run a
mesh: (2, 2), (1, 4), (1, 8) and (pod 2, data 2, model 2).

Parameters are placed by ``param_shardings``, each rank takes its rows of
the batch along the axes ``batch_shardings`` gives (B = 4 over ``data``,
or over ``data`` and then ``pod``: a run of the rows of its cache shard,
which ``cache_shardings`` cuts over ``data`` only, so the two ranks along
``pod`` join their k / v into one shard), and computes its part of every
product ``model`` splits, one layer's leaves gathered at a time. The reduced dense, VLM and MoE configs in f32
prefill a 29-token prompt into a cache of 64 slots and decode 8 tokens
(indices 29-36): slot 32 is a rank's slice boundary on every mesh, and on
(1, 4) and (1, 8) the ranks past it hold no valid slot, so their parts
weigh nothing in the merge. Held to the meshless steps within 1e-5
(relative to the largest value): the prefill's logits, each rank's shard
of its cache, every decode step's logits (the ranks' parts of each product
and of the attention are summed in another order). The reduced
hubert-xlarge takes the prefill only (it has no decode). A cache of 60
slots does not split 8 ways: on (1, 8) it stays whole on each rank (the
undivided route, no merge). No leaf that ``model`` splits is all-gathered
over it (``ModelGathers`` of ``tests/test_torch_tensor_parallel.py``), but
the reduced MoE's column-cut ``w2`` on (1, 8), read whole by design.

On a one-rank mesh both steps are the meshless ones bit for bit. And the
reduced qwen3-1.7b on (1, 4), prefill and 4 decode steps, is held to the
JAX package's ``prefill`` and ``decode_step`` on the same parameters
within 1e-4, the reference computed in this process."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import run_ranks  # noqa: E402
from test_torch_tensor_parallel import _CASES as _TP  # noqa: E402

_HEAD, _MAIN = _TP.split('\nif __name__ == "__main__":')

_CASES = _HEAD + r'''
import numpy as np
from repro_torch.launch.mesh import mesh_shape
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_sharded_prefill_step, make_sharded_serve_step)
from repro_torch.models.convert import params_from_reference
from repro_torch.tree import unflatten

SERVE = {"dense": "qwen3-1.7b", "vlm": "qwen2-vl-7b", "grok": "grok-1-314b", "arctic": "arctic-480b",
         "audio": "hubert-xlarge"}
B, PROMPT, SLOTS, STEPS = 4, 29, 64, 8


def serve_inputs(cfg, steps=STEPS):
    """The prompt batch (B x PROMPT embedded positions) and ``steps`` decode
    tokens, (B, 1) each."""
    if cfg.family in ("vlm", "audio"):
        prompt = make_concrete_batch(cfg, ShapeSpec("p", PROMPT, B, "prefill"), seed=3, device="cpu")
    else:
        prompt = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (B, PROMPT)))}
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (steps, B, 1))
    return prompt, [{"tokens": torch.from_numpy(t)} for t in toks]


def close(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp(min=1e-30))


def worst(values):
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def serve_run(cfg, mesh, params, prompt, toks, slots):
    """The sharded steps against the meshless ones from the same params:
    (prefill logits, cache shard, each decode step's logits) relative
    differences, largest over the ranks; the rank's cache shape."""
    coords = dict(zip(mesh_shape(mesh).axis_names, mesh.get_coordinate()))
    pods = mesh_shape(mesh).shape.get("pod", 1)
    placed = place(params, param_shardings(cfg, params, mesh))
    want, want_cache = make_prefill_step(cfg)(params, prompt, max_seq=slots)
    got, cache = make_sharded_prefill_step(cfg, mesh)(placed, prompt, max_seq=slots)
    rows, (held, n) = got.shape[0], cache["k"].to_local().shape[1:3]
    # the rank's rows: run pod of its cache shard's, run data of the batch's
    r0, c0, s0 = (coords["data"] * pods + coords.get("pod", 0)) * rows, coords["data"] * held, \
        (coords["model"] * n if n < slots else 0)
    errs = [close(got, want[r0 : r0 + rows]),
            max(close(cache[k].to_local(), want_cache[k][:, c0 : c0 + held, s0 : s0 + n]) for k in ("k", "v"))]
    serve, plain = make_sharded_serve_step(cfg, mesh), make_serve_step(cfg)
    for tok in toks:
        want, want_cache = plain(params, want_cache, tok)
        got, cache = serve(placed, cache, tok)
        errs.append(close(got, want[r0 : r0 + rows]))
    assert cache["host_index"] == PROMPT + len(toks) == int(cache["index"].to_local())
    errs.append(max(close(cache[k].to_local(), want_cache[k][:, c0 : c0 + held, s0 : s0 + n]) for k in ("k", "v")))
    return worst(errs), list(cache["k"].to_local().shape)


def case_serve(mesh, out):
    tracker = ModelGathers()
    for name, arch in SERVE.items():
        tracker.seen.clear()
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        prompt, toks = serve_inputs(cfg, 0 if cfg.family == "audio" else STEPS)
        errs, shape = serve_run(cfg, mesh, params, prompt, toks, SLOTS)
        out[name] = {"prefill_rel": errs[0], "cache_rel": max(errs[1], errs[-1]), "decode_rel": errs[2:-1],
                     "cache_shape": shape, "leaves": dict(tracker.seen)}
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    errs, shape = serve_run(cfg, mesh, params, *serve_inputs(cfg), 60)
    out["undivided"] = {"prefill_rel": errs[0], "cache_rel": max(errs[1], errs[-1]), "decode_rel": errs[2:-1],
                        "cache_shape": shape}


def case_one(mesh, out):
    """(1, 1): the sharded steps' bits against the meshless steps'."""
    for name in ("dense", "grok"):
        cfg = dataclasses.replace(get_config(SERVE[name]).reduced(), dtype="float32")
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        prompt, toks = serve_inputs(cfg)
        placed = place(params, param_shardings(cfg, params, mesh))
        want, want_cache = make_prefill_step(cfg)(params, prompt, max_seq=SLOTS)
        got, cache = make_sharded_prefill_step(cfg, mesh)(placed, prompt, max_seq=SLOTS)
        same = [torch.equal(got, want), torch.equal(cache["k"].to_local(), want_cache["k"])]
        for tok in toks:
            want, want_cache = make_serve_step(cfg)(params, want_cache, tok)
            got, cache = make_sharded_serve_step(cfg, mesh)(placed, cache, tok)
            same.append(torch.equal(got, want))
        same.append(torch.equal(cache["v"].to_local(), want_cache["v"]))
        out[name] = same


def case_reference(mesh, out, npz):
    """The reference's parameters (an npz of flattened paths), prefill and
    4 decode steps on ``mesh``; rank 0's logits."""
    data = np.load(npz)
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype="float32")
    params = params_from_reference(unflatten((k, data[k]) for k in data.files if k.startswith("params/")))["params"]
    placed = place(params, param_shardings(cfg, params, mesh))
    tokens = torch.from_numpy(data["tokens"]).long()
    logits, cache = make_sharded_prefill_step(cfg, mesh)(placed, {"tokens": tokens[:, :PROMPT]}, max_seq=SLOTS)
    got = [logits.tolist()]
    serve = make_sharded_serve_step(cfg, mesh)
    for i in range(4):
        logits, cache = serve(placed, cache, {"tokens": tokens[:, PROMPT + i : PROMPT + i + 1]})
        got.append(logits.tolist())
    out["logits"] = got
''' + '\nif __name__ == "__main__":' + _MAIN

MESHES = ("2x2", "1x4", "1x8", "2x2x2")
NAMES = ("dense", "vlm", "grok", "arctic", "audio")


@pytest.fixture(scope="module", params=MESHES)
def serve_run(request, tmp_path_factory):
    return request.param, run_ranks(tmp_path_factory.mktemp("serve"), "serve", request.param, script_text=_CASES,
                                    timeout=400)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_serving_equals_the_meshless_steps(serve_run, name):
    """Prefill logits and each rank's cache shard, then 8 decode steps'
    logits across slot 32, and the cache shard after them, within 1e-5 of
    the meshless steps; each rank holds its cache's rows (4 / data) and 64
    / model slots of every KV head."""
    mesh, results = serve_run
    out = results[name]
    data, model = (int(x) for x in mesh.split("x")[-2:])
    assert out["prefill_rel"] <= 1e-5 and out["cache_rel"] <= 1e-5, (mesh, out)
    assert len(out["decode_rel"]) == (0 if name == "audio" else 8) and max(out["decode_rel"], default=0) <= 1e-5, \
        (mesh, out["decode_rel"])
    assert out["cache_shape"][1:3] == [4 // data, 64 // model], (mesh, out["cache_shape"])
    n = 64 // model
    assert 28 // n != 36 // n  # the decode's indices 29-36 cross a rank's slice boundary


def test_undivided_cache_stays_whole(serve_run):
    """60 slots split 2 and 4 ways but not 8: on (1, 8) every rank holds the
    whole cache and attends over all of it; the logits as the meshless."""
    mesh, results = serve_run
    out = results["undivided"]
    model = int(mesh.split("x")[-1])
    assert out["cache_shape"][2] == (60 if model == 8 else 60 // model), (mesh, out)
    assert out["prefill_rel"] <= 1e-5 and out["cache_rel"] <= 1e-5 and max(out["decode_rel"]) <= 1e-5, (mesh, out)


@pytest.mark.parametrize("name", NAMES)
def test_no_split_leaf_is_gathered_over_model(serve_run, name):
    mesh, results = serve_run
    leaves = results[name]["leaves"]
    split = {p for p, s in leaves.items() if s["split"]}
    gathered = {p for p, s in leaves.items() if s["split"] and s["gathered"]}
    assert {"attn/wq", "attn/wk", "attn/wv", "attn/wo"} <= split, (mesh, sorted(split))
    assert {p for p in split if leaves[p]["mode"] != "local"} == gathered, (mesh, leaves)
    want = {"moe/w2"} if name in ("grok", "arctic") and mesh == "1x8" else set()
    assert gathered == want, (mesh, gathered)


def test_one_rank_mesh_gives_the_meshless_bits(tmp_path):
    out = run_ranks(tmp_path, "one", "1x1", script_text=_CASES)
    for name, same in out.items():
        assert all(same) and len(same) == 11, (name, same)


def test_sharded_serving_against_the_reference(tmp_path):
    """The reduced qwen3-1.7b in f32 on (1, 4): the sharded prefill's logits
    and 4 decode steps' against the JAX package's ``prefill`` (max_seq 64)
    and ``decode_step`` on the same parameters, within 1e-4."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models.model import build_model as ref_build
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(ref_config("qwen3-1.7b").reduced(), dtype="float32")
    fns = ref_build(cfg)
    params = jax.tree.map(np.asarray, fns.init(jax.random.PRNGKey(7)))
    tokens = np.random.default_rng(7).integers(1, cfg.vocab_size, (4, 33)).astype(np.int32)
    npz = tmp_path / "reference.npz"
    np.savez(npz, tokens=tokens, **{"params/" + p: a for p, a in flatten(params)})
    logits, cache = fns.prefill(params, {"tokens": jnp.asarray(tokens[:, :29])}, max_seq=64)
    want = [np.asarray(logits)]
    for i in range(4):
        logits, cache = fns.decode_step(params, cache, {"tokens": jnp.asarray(tokens[:, 29 + i : 30 + i])})
        want.append(np.asarray(logits))
    got = run_ranks(tmp_path, "reference", "1x4", str(npz), script_text=_CASES)["logits"]
    for step, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g, np.float64)
        assert g.shape == w.shape == (4, 1, cfg.vocab_size)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (step, np.abs(g - w).max(), np.abs(w).max())
