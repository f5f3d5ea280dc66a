"""The port's sharding rules (``repro_torch.sharding.specs``) against the JAX
package's: for every arch on both production meshes, every parameter,
optimizer-state, batch and cache leaf gets the shard shape that the
reference's ``NamedSharding(mesh, spec).shard_shape(...)`` gives it. Exact.

The reference needs 512 devices for the multi-pod mesh, so the comparison
runs in a subprocess with 512 fake host devices (as the reference's dry-run
sets them); it evaluates shapes only (``jax.eval_shape``, the port's meta
device) and compiles nothing."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_COMPARE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import torch
torch.set_num_threads(1)
from repro.configs import ARCHS, get_config as ref_config
from repro.configs.base import SHAPES, SHAPE_ORDER
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import batch_spec as ref_batch_spec
from repro.sharding import specs as ref_sh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.specs import batch_spec
from repro_torch.launch.steps import abstract_train_state
from repro_torch.models.model import build_model
from repro_torch.sharding import specs as sh
from repro_torch.tree import flatten


def ref_shapes(shardings, shapes):
    out = {}
    flat_s = jax.tree_util.tree_flatten_with_path(shardings)[0]
    flat_l = jax.tree_util.tree_leaves(shapes)
    for (path, s), l in zip(flat_s, flat_l):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = list(s.shard_shape(l.shape))
    return out


def port_shapes(shardings, tree):
    leaves = dict(flatten(tree))
    return {path: list(s.shard_shape(tuple(leaves[path].shape))) for path, s in flatten(shardings)}


def compare(arch):
    result = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        ms = production_mesh_shape(multi_pod=multi_pod)
        rcfg, cfg = ref_config(arch), get_config(arch)
        rstate = jax.eval_shape(lambda: ref_steps.make_train_state(rcfg, jax.random.PRNGKey(0)))
        state = abstract_train_state(cfg)
        rp = ref_sh.param_shardings(rcfg, rstate["params"], mesh)
        pp = sh.param_shardings(cfg, state["params"], ms)
        got = {"params": port_shapes(pp, state["params"]),
               "opt": port_shapes(sh.opt_state_shardings(cfg, state["opt"], pp, ms), state["opt"])}
        want = {"params": ref_shapes(rp, rstate["params"]),
                "opt": ref_shapes(ref_sh.opt_state_shardings(rcfg, rstate["opt"], rp, mesh), rstate["opt"])}
        for name in SHAPE_ORDER:
            shape = SHAPES[name]
            rspec = ref_batch_spec(rcfg, shape)
            spec = batch_spec(cfg, shape)
            want["batch/" + name] = {k: list(v.shard_shape(rspec[k].shape))
                                     for k, v in ref_sh.batch_shardings(rcfg, rspec, mesh).items()}
            got["batch/" + name] = {k: list(v.shard_shape(spec[k][0]))
                                    for k, v in sh.batch_shardings(cfg, spec, ms).items()}
            if shape.kind == "decode" and rcfg.has_decode:
                rcache = ref_steps.abstract_cache(rcfg, shape.global_batch, shape.seq_len)
                cache = build_model(cfg).init_cache(shape.global_batch, shape.seq_len, device="meta")
                want["cache/" + name] = ref_shapes(
                    ref_sh.cache_shardings(rcfg, rcache, mesh, shape.global_batch), rcache)
                got["cache/" + name] = port_shapes(sh.cache_shardings(cfg, cache, ms, shape.global_batch), cache)
        for key in want:
            assert want[key], (arch, key)
            if got[key] != want[key]:
                diff = {p: (got[key].get(p), want[key].get(p)) for p in set(got[key]) | set(want[key])
                        if got[key].get(p) != want[key].get(p)}
                result[f"{ms.name}/{key}"] = diff
        result[f"{ms.name}/leaves"] = sum(len(v) for v in want.values())
    return result


print(json.dumps({arch: compare(arch) for arch in ARCHS}))
"""


def _archs():
    from repro_torch.configs import ARCHS

    return list(ARCHS)


@pytest.fixture(scope="module")
def compared():
    """{arch: {mesh/tree: mismatches, mesh/leaves: count}} from one subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_COMPARE)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", _archs())
def test_shard_shapes_equal_reference(compared, arch):
    result = compared[arch]
    mismatched = {k: v for k, v in result.items() if not k.endswith("/leaves")}
    assert not mismatched, mismatched
    assert result["16x16/leaves"] > 20 and result["2x16x16/leaves"] == result["16x16/leaves"]
