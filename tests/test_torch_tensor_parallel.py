"""The sharded train step's tensor-parallel compute over ``model``
(``sharding/fsdp.py``'s modes and conjugates, ``models/layers.py``,
``models/model.py``'s head and vocabulary-parallel cross-entropy) on gloo
ranks on the CPU, one process a rank (``run_ranks`` of
``tests/test_torch_distributed.py``), one run a mesh:

* (2, 2): two query heads and one whole KV head a rank; MoE's 4 experts
  two a rank (expert parallelism);
* (1, 4): one query head and half a KV head a rank; one expert a rank;
* (1, 8): half a query head and a quarter of a KV head a rank; 4 experts
  do not divide 8, so each expert's hidden is cut (per-expert tensor
  parallelism; the reduced configs' d_model = moe.d_ff, so the placements
  cut the experts' ``w2`` by columns: gathered whole, ``tp_modes``).

On each, the reduced dense, VLM, audio and both MoE configs in f32 take 4
steps of the tensor-parallel step, held to the unsharded
``make_train_step`` within 1e-5 (the ranks' parts of each product are
summed in another order): the losses and gradient norms, every gradient at
the parameters each step starts from, and the MoE pair's parameters by
``max_rel_leaf``; each step's new state within 1e-6 of the unsharded
optimizer fed its gradients. A vocabulary of 510 does not divide 4 or 8, so there the head is
replicated, as the reference's ``tp_ok`` places it. No leaf a rank computes
its part with is ever all-gathered over ``model`` (the gathers tracked as
``tests/test_torch_fsdp.py``'s ``Tracker`` does). The vocabulary-parallel
``cross_entropy`` equals ``cross_entropy`` over the whole logits within
1e-6, value and gradient, with ignored labels and labels on every rank.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import _RANK, run_ranks  # noqa: E402

_CASES = _RANK.split('\nif __name__ == "__main__":')[0] + r'''
from repro_torch.launch.specs import make_concrete_batch
from repro_torch.models.model import cross_entropy
from repro_torch.sharding import fsdp

ARCHS = {"dense": "qwen3-1.7b", "vlm": "qwen2-vl-7b", "audio": "hubert-xlarge", "grok": "grok-1-314b",
         "arctic": "arctic-480b"}


def arch_batches(cfg, n):
    if cfg.family in ("audio", "vlm"):
        return [make_concrete_batch(cfg, SHAPE, seed=i, device="cpu") for i in range(n)]
    return batches(cfg, n)


class ModelGathers:
    """Wraps ``fsdp.gather`` and ``fsdp._Gather.forward``: for each leaf a
    gather hands over, by its path in the gathered tree, its mode and
    whether ``model`` splits it, and whether the forward all-gathered it
    over ``model``."""

    def __init__(self):
        self.seen = {}
        gather, forward = fsdp.gather, fsdp._Gather.forward
        tracker, paths = self, {}

        def gather_(tree, modes=None):
            dims = fsdp.model_dims(tree)
            for p, t in flatten(tree):
                if p in dims:
                    paths[id(t)] = p
                    tracker.seen.setdefault(p, {"mode": (modes or {}).get(p, "whole"), "split": dims[p] is not None,
                                                "gathered": False})
            return gather(tree, modes)

        def forward_(ctx, spec, *shards):
            for t, cut in zip(shards, spec.leaves):
                if cut.dim_of("model") is not None:
                    tracker.seen[paths[id(t)]]["gathered"] = True
            return forward(ctx, spec, *shards)

        fsdp.gather = gather_
        fsdp._Gather.forward = staticmethod(forward_)


def unsharded(cfg, data):
    """(state, losses, grad norms) of the unsharded step over ``data``."""
    step = make_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=30)
    state, losses, norms = fresh(cfg), [], []
    for b in data:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def case_tp(mesh, out):
    tracker = ModelGathers()
    cfgs = {name: dataclasses.replace(get_config(arch).reduced(), dtype="float32") for name, arch in ARCHS.items()}
    cfgs["vocab510"] = dataclasses.replace(cfgs["dense"], vocab_size=510)
    for name, cfg in cfgs.items():
        tracker.seen.clear()
        data = arch_batches(cfg, 4)
        st, got, got_norms, grad_rel, update_rel = checked_steps(cfg, mesh, data)
        ref, want, want_norms = unsharded(cfg, data)
        by_leaf = {p: max_rel_leaf({"x": a}, {"x": b}) for (p, a), (_, b) in zip(flatten(st["params"]),
                                                                                flatten(ref["params"]))}
        out[name] = {"loss_rel": rel(got, want), "norm_rel": rel(got_norms, want_norms), "grad_rel": grad_rel,
                     "update_rel": update_rel, "params_rel": max_rel_leaf(st["params"], ref["params"]),
                     "beyond": {p: r for p, r in by_leaf.items() if r > 1e-5},
                     "leaves": dict(tracker.seen),
                     "embed": list(st["params"]["head"]["embed"].to_local().shape)}
    tp = fsdp.mesh_axes(mesh, ("model",))[0]
    gen = torch.Generator().manual_seed(5)
    n, v = 24, 64 * tp.size
    logits = torch.randn((2, n, v), generator=gen, dtype=torch.float64).float() * 4
    labels = torch.randint(0, v, (2, n), generator=gen)
    labels[0, :3] = -1
    labels[1, : tp.size] = torch.arange(tp.size) * (v // tp.size) + 7  # a label in every rank's slice
    whole = logits.clone().requires_grad_()
    want = cross_entropy(whole, labels)
    want.backward()
    part = logits[..., tp.index * 64:(tp.index + 1) * 64].clone().requires_grad_()
    with fsdp.use_fsdp(fsdp.Fsdp([], [], (), tp)):
        got = cross_entropy(part, labels, axis=tp)
        got.backward()
    grad_want = whole.grad[..., tp.index * 64:(tp.index + 1) * 64]
    errs = torch.tensor([abs(float(got) - float(want)) / abs(float(want)),
                         float((part.grad - grad_want).abs().max() / grad_want.abs().max())])
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    owners = torch.zeros(tp.size)
    owners[tp.index] = float(((labels >= tp.index * 64) & (labels < (tp.index + 1) * 64)).sum())
    dist.all_reduce(owners)
    out["ce"] = {"value_rel": float(errs[0]), "grad_rel": float(errs[1]), "labels_a_rank": owners.tolist(),
                 "ignored": int((labels == -1).sum())}
''' + '\nif __name__ == "__main__":' + _RANK.split('\nif __name__ == "__main__":')[1]

MESHES = ("2x2", "1x4", "1x8")
NAMES = ("dense", "vlm", "audio", "grok", "arctic", "vocab510")


@pytest.fixture(scope="module", params=MESHES)
def tp_run(request, tmp_path_factory):
    return request.param, run_ranks(tmp_path_factory.mktemp("tp"), "tp", request.param, script_text=_CASES,
                                    timeout=400)


@pytest.mark.parametrize("name", NAMES)
def test_tp_step_equals_the_unsharded_step(tp_run, name):
    """4 f32 steps: the losses and the gradient norms within 1e-5 of the
    unsharded step's; at the parameters each step starts from, every
    gradient leaf within 1e-5 of the unsharded gradient; the state each
    step leaves within 1e-6 of the unsharded optimizer applied to the whole
    state it started from with the step's own gradients gathered; the MoE
    pair's parameters (Adafactor) within 1e-5 of the unsharded step's after
    the 4 steps. So a step is held from its state to the next: the
    gradients, then what follows them on the shards (the norm, the
    optimizer).

    The parameters of the AdamW configs are not held to the unsharded
    run's: AdamW divides each element's first moment by its own RMS, so
    where an element's gradients nearly cancel over the steps a 1e-6
    difference in them (the ranks' parts of a product summed in another
    order) moves it by more (dense (2, 2): 1.6e-5 in ``embed``, its
    gradients within 1.4e-6). Nor under SGD at this schedule: there the
    update, about 1e-5 of a parameter, is read through the f32 rounding of
    ``p - lr * g`` (1.2e-3 of ``lm_head``'s update on (2, 2)). The VLM's
    ``bk`` has a gradient of zero in exact arithmetic (softmax does not see
    a bias every key of a query shares), so its relative difference is the
    order of the sums alone and is not held, as ``tests/test_torch_fsdp.py``
    does not hold it."""
    mesh, results = tp_run
    out = results[name]
    assert out["loss_rel"] <= 1e-5 and out["norm_rel"] <= 1e-5, (mesh, out["loss_rel"], out["norm_rel"])
    grads = {p: r for p, r in out["grad_rel"].items() if not (name == "vlm" and p == "layers/attn/bk")}
    assert max(grads.values()) <= 1e-5, (mesh, grads)
    assert out["update_rel"] <= 1e-6, (mesh, out["update_rel"])
    if name in ("grok", "arctic"):
        assert out["params_rel"] <= 1e-5, (mesh, out["beyond"])


@pytest.mark.parametrize("name", NAMES)
def test_no_split_leaf_is_gathered_over_model(tp_run, name):
    """Every leaf that ``model`` splits is kept as the rank's shard and never
    all-gathered over ``model``, but for the experts' ``w2`` that the
    reduced MoE configs' placements cut by columns, which the per-expert
    split of (1, 8) reads whole; the per-head norms are gathered whole and
    their gradients summed. A vocabulary of 510 stays whole where 4 or 8
    ranks do not divide it."""
    mesh, results = tp_run
    out = results[name]
    leaves = out["leaves"]
    model = int(mesh.split("x")[1])
    split = {p for p, s in leaves.items() if s["split"]}
    gathered = {p for p, s in leaves.items() if s["split"] and s["gathered"]}
    assert {p for p in split if leaves[p]["mode"] != "local"} == gathered, (mesh, leaves)
    if name in ("grok", "arctic") and model == 8:
        assert gathered == {"moe/w2"}, (mesh, gathered)
    else:
        assert not gathered, (mesh, gathered)
    assert {"attn/wq", "attn/wo", "attn/wk", "attn/wv"} <= split, (mesh, sorted(split))
    if name == "dense":
        assert leaves["attn/q_norm"]["mode"] == leaves["attn/k_norm"]["mode"] == "sum", leaves
    vocab = 510 if name == "vocab510" else 512
    assert out["embed"][0] == (vocab if vocab % model else vocab // model), (mesh, out["embed"])
    assert ("embed" in split or "lm_head" in split) == (vocab % model == 0), (mesh, sorted(split))


def test_vocab_parallel_cross_entropy(tp_run):
    """Value and gradient within 1e-6 of the whole logits' on every rank;
    3 labels ignored; every rank owns some label."""
    mesh, results = tp_run
    out = results["ce"]
    assert out["value_rel"] <= 1e-6 and out["grad_rel"] <= 1e-6, (mesh, out)
    assert out["ignored"] == 3 and min(out["labels_a_rank"]) > 0, (mesh, out)


@pytest.mark.parametrize("mesh", MESHES)
def test_kernels_cuda_paths_take_the_shard_shapes(mesh):
    """The dry-run's memory pass of each reduced config on one rank of the
    mesh, with the kernels' CUDA paths up to the launch (meta tensors,
    ``card=True``): every kernel's checks (contiguity, shapes, dtypes, the
    route rules) pass at the shard shapes, straddled query heads included
    (half a head a rank on (1, 8))."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    for arch in ("qwen3-1.7b", "qwen2-vl-7b", "hubert-xlarge", "grok-1-314b", "arctic-480b", "minicpm-2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
        mem = dryrun.build_cell(cfg, ShapeSpec("t", 64, 4, "train"), mesh, card=True).mem
        assert mem["temp_bytes"] > 0 and mem["temp_breakdown"]["attention"] > 0, (arch, mem)
