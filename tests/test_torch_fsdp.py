"""The sharded train step's per-layer gathers (``sharding/fsdp.py``,
``launch/steps.make_sharded_train_step``) on 8 gloo ranks on the CPU, one
process a rank (``run_ranks`` of ``tests/test_torch_distributed.py``).

* Memory: with remat, a rank holds at most one layer's gathered leaves (one
  hybrid group's), and one layer's whole gradients, beside the head's, and
  the peak of what the gathers hold (gathered leaves, the whole gradients
  their backward receives, the gradient shards made so far; weakrefs note
  each tensor's end) is what the order of the gathers gives. And
  ``roofline.memory.count`` over a rank's real step (every storage an op
  makes, while it lives) equals the dry-run's count on meta for the same
  config, shape and mesh: ``temp_bytes``, and the bytes by kind at the
  peak, the gathered leaves and whole gradients (``gathers``) and the
  gradient shards (``gradients``) among them.
* Each family's sharded step equals the unsharded one within 1e-5 (losses,
  and parameters by ``max_rel_leaf``; the VLM's gradients at each step's
  state) over 4 steps in f32 on (2, 4): the gradients are summed over the
  ranks, and the products split over ``model`` summed, in another order.
  Each step's new state is within 1e-6 of the unsharded optimizer fed the
  step's own gradients.
* On one rank, (1, 1), the step keeps the unsharded step's bits: nothing
  is gathered or summed. (On (1, 8) the products split over ``model`` sum
  their parts in another order: ``tests/test_torch_tensor_parallel.py``.)
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import _RANK, run_ranks  # noqa: E402

_CASES = _RANK.split('\nif __name__ == "__main__":')[0] + r'''
import weakref
from repro_torch.launch import dryrun
from repro_torch.launch.specs import make_concrete_batch
from repro_torch.roofline import memory
from repro_torch.sharding import fsdp

FAMILIES = {"dense": "qwen3-1.7b", "ssm": "mamba2-1.3b", "hybrid": "recurrentgemma-9b",
            "audio": "hubert-xlarge", "vlm": "qwen2-vl-7b"}
HEAD = {"embed", "lm_head", "final_norm"}


def family_batches(cfg, n):
    """The pipeline's tokens for the token families; for audio and the VLM
    the reference's random batches (frame masks at 30%, so each rank's rows
    carry another number of labels)."""
    if cfg.family in ("audio", "vlm"):
        return [make_concrete_batch(cfg, SHAPE, seed=i, device="cpu") for i in range(n)]
    return batches(cfg, n)


def steps(cfg, mesh, data, **kw):
    sched = {"peak_lr": 1e-3, "warmup": 5, "total_steps": 30}
    step = make_train_step(cfg, **sched, **kw) if mesh is None else make_sharded_train_step(cfg, mesh, **sched, **kw)
    state = fresh(cfg, mesh)
    losses = []
    for b in data:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


class Tracker:
    """Wraps ``fsdp.gather`` and ``fsdp._Gather``'s forward and backward.
    Live: each gathered leaf (a tensor the forward makes) and each whole
    gradient the backward receives, with the gather call it belongs to,
    until weakref's finalize says it is gone; held: each gradient shard the
    backward returns, once a local shard (every one is kept to the
    optimizer, alone or stacked). Samples at each forward's end and each
    backward's start and end: the bytes, and how many layers' (hybrid
    groups') gathered leaves and whole gradients are live beside the
    head's."""

    def __init__(self):
        self.live, self.shards, self.owners = {}, {}, []
        self.peak = self.most_layers = self.most_whole = self.calls = self.n = 0
        self.label = None
        gather, forward, backward = fsdp.gather, fsdp._Gather.forward, fsdp._Gather.backward
        tracker = self

        def gather_(tree, modes=None):
            tracker.label = "head" if HEAD & set(tree) else tracker.calls
            tracker.calls += 1
            return gather(tree, modes)

        def forward_(ctx, spec, *shards):
            outs = forward(ctx, spec, *shards)
            ctx.owners, ctx.label = [id(t) for t in shards], tracker.label
            tracker.owners.extend(shards)  # the local shards' ids stay theirs
            for t, o in zip(shards, outs):
                if o.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
                    tracker.add(o, "gathered", ctx.label)
            tracker.sample()
            return outs

        def backward_(ctx, *grads):
            for g in grads:
                tracker.add(g, "whole", ctx.label)
            tracker.sample()
            res = backward(ctx, *grads)
            for owner, g in zip(ctx.owners, res[1:]):
                tracker.shards.setdefault(owner, g.numel() * g.element_size())
            tracker.sample()
            return res

        fsdp.gather = gather_
        fsdp._Gather.forward = staticmethod(forward_)
        fsdp._Gather.backward = staticmethod(backward_)

    def add(self, t, kind, label):
        self.n += 1
        self.live[self.n] = (t.numel() * t.element_size(), kind, label)
        weakref.finalize(t, self.live.pop, self.n, None)

    def sample(self):
        def layers(kind):
            return len({label for _, k, label in self.live.values() if k == kind and label != "head"})

        self.most_layers = max(self.most_layers, layers("gathered"))
        self.most_whole = max(self.most_whole, layers("whole"))
        self.peak = max(self.peak, sum(b for b, _, _ in self.live.values()) + sum(self.shards.values()))


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf as one gather sees it (a layer of a stacked leaf): its shape
    whole, its shard's, the shape the gather hands over (the ``model``
    shard kept in mode ``local``), its dtype, and whether the gather
    handles it (gathers it over some axis, or sums its gradient)."""

    shape: tuple
    shard: tuple
    gathered: tuple
    dtype: torch.dtype
    handled: bool


@dataclasses.dataclass(frozen=True)
class Group:
    """One call of ``fsdp.gather`` in the sharded step's forward (the
    embedding, a layer, a hybrid group or trailing layer, the LM head): its
    leaves, and ``remat``, whether it runs under remat (the replay gathers
    its leaves again)."""

    remat: bool
    leaves: tuple


def gather_groups(cfg, params, specs, ms, batch_axes, batch):
    """The sharded step's gathers in the order of the forward (``models/model.py``):
    the embedding where the inputs use it, each layer (a hybrid group of
    (rec, rec, attn), then its trailing recurrent layers outside remat),
    then the LM head's final norm with ``lm_head`` or, tied, ``embed``
    again; each leaf's mode by ``layers.tp_modes`` where the model computes
    its part of the products (the attention families' layers and every
    head), ``whole`` elsewhere."""
    from repro_torch.models.layers import tp_modes
    from repro_torch.sharding import specs as sh

    names = dict(flatten(params))
    model = ms.shape["model"]

    def leaf(path, layer=None):
        t, s = names[path], specs["params/" + path]
        shape, spec = (tuple(t.shape), s.spec) if layer is None else (tuple(t.shape[1:]), s.spec[1:])
        sharding = sh.LeafSharding(ms, spec)
        return path, shape, sharding, t.dtype

    def group(remat, items, tp):
        """``items`` (path, shape, placement, dtype); ``tp``: whether the
        model computes its part of these leaves' products."""
        rel = [p.split("/", 2)[-1] if p.startswith("layers/") else p.split("/")[-1] for p, _, _, _ in items]
        dims = [next((d for d in range(len(shape)) if "model" in s.axes(d)), None) for _, shape, s, _ in items]
        modes = tp_modes(dict(zip(rel, dims))) if tp and model > 1 else {}
        out = []
        for r, dim, (_, shape, sharding, dtype) in zip(rel, dims, items):
            shard = sharding.shard_shape(shape)
            mode = modes.get(r, "whole")
            gathered = tuple(shard[d] if mode == "local" and d == dim else n for d, n in enumerate(shape))
            over = [a for d in range(len(shape)) for a in sharding.axes(d) if ms.shape[a] > 1
                    and not (mode == "local" and a == "model")]
            out.append(Leaf(shape, shard, gathered, dtype, bool(over or batch_axes or mode == "sum")))
        return Group(remat, tuple(out))

    def stack(prefix, i):
        return [leaf(p, i) for p in names if p.startswith(prefix + "/")]

    groups = []
    if cfg.family != "audio" or "frame_mask" in batch:
        groups.append(group(False, [leaf("head/embed")], True))
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // len(cfg.rglru.pattern)
        n_rec = sum(1 for k in cfg.layer_kinds() if k == "rec")
        for g in range(n_groups):
            items = stack("rec_layers", 2 * g) + stack("rec_layers", 2 * g + 1) + stack("attn_layers", g)
            groups.append(group(cfg.remat, items, False))
        for i in range(2 * n_groups, n_rec):
            groups.append(group(False, stack("rec_layers", i), False))
    else:
        for layer in range(cfg.num_layers):
            groups.append(group(cfg.remat, stack("layers", layer), cfg.family != "ssm"))
    head = "head/embed" if cfg.tie_embeddings else "head/lm_head"
    groups.append(group(False, [leaf("head/final_norm"), leaf(head)], True))
    return groups


def gathers_peak(cfg, mesh):
    """What the tracker's peak should be, from the step's order of gathers
    (:func:`gather_groups`) alone: the most held at each gather's end
    and each gather backward's start and end, of the gathered leaves (a
    group under remat only during its call and its replay; one outside
    remat until its backward), the whole gradients a gather backward
    receives, and the gradient shards made so far (the tied head's second
    gather of ``embed`` makes no new one). The backward runs the groups in
    reverse; a group's gathered leaves are gone when its backward starts."""
    from repro_torch.sharding import specs as sh
    from repro_torch.launch.steps import abstract_train_state

    ms = mesh_shape(mesh)
    _, batch, _, axes = dryrun._local_batch(cfg, SHAPE, ms)
    state = abstract_train_state(cfg)
    specs = dict(flatten(sh.state_shardings(cfg, state, ms)))
    groups = gather_groups(cfg, state["params"], specs, ms, tuple(a for a in axes if ms.shape[a] > 1), batch)
    embed = cfg.family != "audio" or "frame_mask" in batch

    def nbytes(shape, leaf):
        return math.prod(shape) * torch.empty((), dtype=leaf.dtype).element_size()

    def whole(g, only_split):
        return sum(nbytes(leaf.gathered, leaf) for leaf in g.leaves
                   if leaf.handled and (not only_split or leaf.gathered != leaf.shard))

    def layer(i):
        return (i > 0 or not embed) and i < len(groups) - 1

    peak = kept = 0
    for i, g in enumerate(groups):
        if layer(i) and not g.remat:
            kept += whole(g, True)
            peak = max(peak, kept)
        else:
            peak = max(peak, kept + whole(g, True))
    held = 0
    for i in reversed(range(len(groups))):
        g = groups[i]
        if layer(i):
            if g.remat:
                peak = max(peak, whole(g, True) + held)
            else:
                kept -= whole(g, True)
        w = whole(g, False)
        peak = max(peak, kept + w + held)
        tied = i == len(groups) - 1 and embed and cfg.tie_embeddings
        held += sum(nbytes(leaf.shard, leaf) for leaf in (g.leaves[:-1] if tied else g.leaves) if leaf.handled)
        peak = max(peak, kept + w + held)
    return peak


def case_memory(mesh, out, arch):
    """(2, 4): one step of ``arch`` reduced, f32, remat on, with the gathers
    tracked; then one under ``roofline.memory.count``, each rank's count
    beside the dry-run's for the same config, shape and mesh, on meta with
    the kernels' plain versions (the CPU's)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", remat=True)
    tracker = Tracker()
    state, _ = steps(cfg, mesh, batches(cfg, 1))
    out.update(peak=tracker.peak, most_layers=tracker.most_layers, most_whole=tracker.most_whole,
               calls=tracker.calls, expected_peak=gathers_peak(cfg, mesh))
    step = make_sharded_train_step(cfg, mesh, peak_lr=1e-3, warmup=5, total_steps=30)
    _, held = memory.count(step, state, batches(cfg, 1, start=1)[0])
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, dataclasses.asdict(held))
    mem = dryrun.build_cell(cfg, SHAPE, "2x4", card=False).mem
    out.update(counts=counts, temp=mem["temp_bytes"], temp_breakdown=mem["temp_breakdown"])


def split_order(cfg, data, n):
    """The unsharded step in one process with each batch's gradient summed
    from its n runs of rows in order, each weighted by its share of the
    labels: a batch split's order of sums, and nothing distributed."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import _train_step_parts, grad_norm
    from repro_torch.models.model import loss_tokens

    _, apply = _train_step_parts(cfg, 1e-3, 5, 30, 0)
    fns, state = build_model(cfg), fresh(cfg)
    ms = MeshShape(("data", "model"), (n, 1))
    for b in data:
        runs = [split_batch(b, ("data",), ms, {"data": i}) for i in range(n)]
        total = sum(loss_tokens(cfg, r).float() for r in runs)
        grads = None
        for r in runs:
            loss, aux, g = value_and_grad(fns, state["params"], r)
            g = [x * (loss_tokens(cfg, r).float() / total) for x in g]
            grads = g if grads is None else [a + x for a, x in zip(grads, g)]
        state, _ = apply(state, loss, aux, grads, grad_norm(grads))
    return state


def case_families(mesh, out):
    """(2, 4): 4 f32 steps of each family, sharded, unsharded, and unsharded
    in the split's order of sums."""
    for family, arch in FAMILIES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        data = family_batches(cfg, 4)
        st, got, _, grads, update = checked_steps(cfg, mesh, data)
        ref, want = steps(cfg, None, data)
        by_leaf = {p: max_rel_leaf({"x": a}, {"x": b}) for (p, a), (_, b) in zip(flatten(st["params"]),
                                                                                flatten(ref["params"]))}
        out[family] = {"loss_rel": rel(got, want), "params_rel": max_rel_leaf(st["params"], ref["params"]),
                       "beyond": sorted(p for p, r in by_leaf.items() if r > 1e-5), "grad_rel": grads,
                       "update_rel": update,
                       "split_order_rel": max_rel_leaf(st["params"], split_order(cfg, data, 2)["params"])}


def case_unsplit(mesh, out):
    """(1, 1): the dense model in f32 and bf16 and the MoE model, sharded and not."""
    for name, arch, dtype in (("dense", "qwen3-1.7b", "float32"), ("dense_bf16", "qwen3-1.7b", "bfloat16"),
                              ("moe", "grok-1-314b", "float32")):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        st, got = steps(cfg, mesh, batches(cfg, 3))
        ref, want = steps(cfg, None, batches(cfg, 3))
        out[name] = {"losses": got, "ref": want, "params_rel": max_rel_leaf(st["params"], ref["params"])}
''' + '\nif __name__ == "__main__":' + _RANK.split('\nif __name__ == "__main__":')[1]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b", "grok-1-314b"])
def test_one_layer_gathered_at_a_time(tmp_path, arch):
    """(2, 4), remat on: never more than one layer's (one hybrid group's)
    gathered leaves, nor one layer's whole gradients, beside the head's; the
    tracked peak of the gathers (gathered leaves, whole gradients, gradient
    shards) is what the order of the gathers gives, and no more than the
    gathers' and the gradients' kinds hold in the count; and every rank's
    count of the whole step is the dry-run's ``temp_bytes``, and what it
    held then, kind by kind, its ``temp_breakdown``."""
    out = run_ranks(tmp_path, "memory", "2x4", arch, script_text=_CASES)
    assert out["most_layers"] == 1 and out["most_whole"] == 1, out
    assert out["peak"] == out["expected_peak"] > 0, out
    assert out["temp_breakdown"]["gathers"] > 0 and out["temp_breakdown"]["gradients"] > 0, out
    for count in out["counts"]:
        assert out["peak"] <= count["held"]["gathers"] + count["held"]["gradients"], out
        assert count["peak"] == out["temp"] > 0, out
        assert count["breakdown"] == out["temp_breakdown"], out


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("families"), "families", "2x4", script_text=_CASES, timeout=400)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "audio", "vlm"])
def test_each_family_equals_the_unsharded_step(families, family):
    """qwen3-1.7b, mamba2-1.3b, recurrentgemma-9b (3 layers), hubert-xlarge
    (frame masks: each rank's rows another label count) and qwen2-vl-7b:
    losses within 1e-5 of the unsharded step's, and parameters within 1e-5
    of it and of the unsharded step summing the same runs of rows in one
    process. The VLM's ``bk`` and a few elements of its ``embed`` and
    ``attn_norm`` move with the order of the sums alone: ``bk``'s gradient
    is zero in exact arithmetic (softmax does not see a bias every key of a
    query shares), the elements' gradients nearly cancel over the steps,
    and AdamW divides each by its own RMS. With the batch split alone the
    unsharded step summing the same runs of rows gave the same bits for
    them; the products split over ``model`` sum in an order that no run in
    one process repeats. So the VLM is held, at the state each step starts
    from, by every gradient but ``bk``'s within 1e-5 of the unsharded
    step's, and each family, each step, by the state it leaves: within
    1e-6 of the unsharded optimizer applied to the whole state it started
    from with its own gradients gathered (``checked_steps``)."""
    out = families[family]
    assert out["loss_rel"] <= 1e-5 and out["update_rel"] <= 1e-6, out
    if family == "vlm":
        assert max(r for p, r in out["grad_rel"].items() if p != "layers/attn/bk") <= 1e-5, out
    else:
        assert out["split_order_rel"] <= 1e-5 and out["params_rel"] <= 1e-5 and not out["beyond"], out


@pytest.fixture(scope="module")
def unsplit(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("unsplit"), "unsplit", "1x1", script_text=_CASES)


@pytest.mark.parametrize("name", ["dense", "dense_bf16", "moe"])
def test_nothing_split_keeps_the_bits(unsplit, name):
    """(1, 1): one rank holds the batch and every leaf whole; no collective
    runs. Losses bit for bit, and the parameters too. (On (1, 8) ``model``
    splits the products and their parts sum in another order: within 1e-5,
    ``tests/test_torch_tensor_parallel.py``.)"""
    out = unsplit[name]
    assert out["losses"] == out["ref"], out
    assert out["params_rel"] == 0.0, out
