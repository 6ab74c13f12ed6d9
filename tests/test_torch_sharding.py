"""The LM testbed's sharding: ``repro_torch.launch.mesh``,
``distributed.sharding`` and the sharded steps of ``distributed.spmd``
against the reference's ``repro.launch.mesh`` and
``repro.distributed.sharding``; ``restore(shardings=)``.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names``, so the spec trees are compared in process on a
stand-in mesh at every size, (16, 16) and (2, 16, 16) included, with the
port's parameter shapes built on ``meta`` and the reference's from
``jax.eval_shape``.  Layouts, ``constrain`` and the sharded train step
need JAX devices, which ``--xla_force_host_platform_device_count`` gives
only before JAX starts, so the reference runs them in one 8-device
subprocess: ``device_put`` pieces on a (2, 2) data/model and a (2, 2, 2)
pod/data/model mesh, jitted ``constrain``/``kv_cache_constraint``
output shardings, and the reference test's sharded train step (glm4-9b's
smoke config at f32, (2, 2), batch 4 x 32), also with masked labels.

Bounds: the port's sharded step holds the reference's sharded step at
the reference test's tolerance (loss 1e-4, parameters rtol 5e-3 atol
5e-5) and equals the port's unsharded step with 2 microbatches (1 on
MoE) bit for bit.  Sharded prefill and decode give the unsharded port's
tokens; their logits and cache are equal bit for bit where a group
holds 2 or more rows, and within 1e-5 where a group holds one row (the
CPU's BLAS takes another kernel for a single row).
"""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lm import ARCHS, carried_params, smoke, to_numpy
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import lm as ref_lm
from repro.runtime import checkpoint as ref_ckpt
from repro_torch.configs import SHAPE_CELLS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import Mesh, current_mesh, make_test_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train import step as tstep

REPO = Path(__file__).resolve().parent.parent
MESHES = [((2, 2), ("data", "model")), ((4, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
ONE_ROW_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _StandIn:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _ref_flat(tree):
    """{path: spec entries} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "name", str(k))) for k in path): _norm(s)
            for path, s in leaves}


def _port_flat(tree):
    out = {}
    shd._tree_map(lambda path, s: out.__setitem__(tuple(path), _norm(s)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = ref_get_config(arch)
    return cfg, jax.eval_shape(lambda: ref_lm.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh_shape,axes", MESHES, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, mesh_shape, axes):
    """param_specs + _fix_divisibility, batch_specs of every cell,
    cache_partition_specs at batch 1 and 128, train_state_shardings."""
    rcfg, rshapes = _ref_shapes(arch)
    cfg = get_config(arch)
    pshapes = lm.init_params(cfg, device="meta")
    rmesh = _StandIn(mesh_shape, axes)
    pmesh = make_test_mesh(mesh_shape, axes, device="meta")
    want = _ref_flat(ref_shd._fix_divisibility(
        ref_shd.param_specs(rcfg, rmesh, rshapes), rshapes, rmesh))
    got = _port_flat(shd._fix_divisibility(shd.param_specs(cfg, pmesh, pshapes),
                                           pshapes, pmesh))
    assert got == want
    p_sh, o_sh = shd.train_state_shardings(cfg, pmesh, pshapes, None)
    assert _port_flat(shd.spec_tree(p_sh)) == want
    assert _port_flat(shd.spec_tree(o_sh.m)) == want
    assert _port_flat(shd.spec_tree(o_sh.v)) == want
    assert o_sh.step.spec == shd.P() and o_sh.step.mesh is pmesh
    for name, cell in SHAPE_CELLS.items():
        assert _port_flat(shd.batch_specs(cfg, pmesh, cell)) == _ref_flat(
            ref_shd.batch_specs(rcfg, rmesh, REF_CELLS[name])), name
    for batch in (1, 128):
        assert _port_flat(shd.cache_partition_specs(cfg, pmesh, batch)) == _ref_flat(
            ref_shd.cache_partition_specs(rcfg, rmesh, batch)), batch


# -- the reference on 8 host devices --------------------------------------------

LAYOUTS = [
    ((2, 2), ("data", "model"), (8, 12), (None, "model")),
    ((2, 2), ("data", "model"), (8, 12), ("data",)),
    ((2, 2), ("data", "model"), (8, 12), ("data", "model")),
    ((2, 2), ("data", "model"), (8, 12), (("data", "model"), None)),
    ((2, 2), ("data", "model"), (8, 12), (None, ("model", "data"))),
    ((2, 2), ("data", "model"), (4, 8, 6), ()),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6), (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6), ("model", None, None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6), (("pod", "data", "model"),)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 8), (None, "pod", ("data", "model"))),
]
CONSTRAINTS = [
    ((2, 2), ("data", "model"), (4, 6, 8), (("pod", "data"), None, "model")),
    ((2, 2), ("data", "model"), (3, 6, 8), (("pod", "data"), None, "model")),
    ((2, 2), ("data", "model"), (4, 5, 7), (("pod", "data"), "model", None)),
    ((2, 2), ("data", "model"), (4, 6), ("pipe", "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 6, 8), (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (2, 6, 8), (("pod", "data"), None, "model")),
]
KV_CACHES = [  # mesh, (B, Sc, KV, hd)
    ((2, 2), ("data", "model"), (4, 8, 2, 4)),
    ((2, 2), ("data", "model"), (4, 8, 3, 4)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8, 1, 4)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 8, 4, 4)),
]

REF_SCRIPT = r"""
import json, sys
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.configs.base import ShapeCell
from repro.distributed import sharding as shd
from repro.launch.mesh import make_test_mesh
from repro.models import lm
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.train.step import make_train_step

cases = json.loads(sys.argv[2])
out, meta = {}, {}
def tup(e):
    return tuple(e) if isinstance(e, list) else e
for i, (shape, axes, xshape, spec) in enumerate(cases["layouts"]):
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    x = np.arange(np.prod(xshape), dtype=np.float32).reshape(xshape)
    arr = jax.device_put(x, NamedSharding(mesh, P(*map(tup, spec))))
    order = {d.id: k for k, d in enumerate(mesh.devices.flat)}
    shards = sorted(arr.addressable_shards, key=lambda s: order[s.device.id])
    for k, s in enumerate(shards):
        out[f"layout{i}_{k}"] = np.asarray(s.data)
        meta[f"layout{i}_{k}"] = [list(sl.indices(n)[:2]) for sl, n in zip(s.index, xshape)]
def spec_of(a):
    return [list(e) if isinstance(e, tuple) else e for e in a.sharding.spec]
for i, (shape, axes, xshape, spec) in enumerate(cases["constraints"]):
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    x = jnp.ones(xshape)
    with mesh:
        y = jax.jit(lambda x: shd.constrain(x, *map(tup, spec)))(x)
    meta[f"constrain{i}"] = spec_of(y)
for i, (shape, axes, xshape) in enumerate(cases["kv"]):
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    x = jnp.ones(xshape)
    with mesh:
        y = jax.jit(lambda x: shd.kv_cache_constraint(x, xshape[2], xshape[3]))(x)
    meta[f"kv{i}"] = spec_of(y)

# the reference test's sharded train step (tests/test_distributed.py:80-126)
cfg = dataclasses.replace(get_smoke_config("glm4-9b"), activation_dtype="float32")
key = jax.random.PRNGKey(0)
params = lm.init_params(cfg, key)
opt = adamw_init(params)
tokens = jax.random.randint(key, (4, 32), 0, cfg.vocab_size)
labels = jnp.roll(tokens, -1, axis=1)
masked = labels.at[:, -1].set(-1).at[0, :9].set(-1)
step = make_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10))
mesh = make_test_mesh((2, 2), ("data", "model"))
cell = ShapeCell("t", 32, 4, "train")
with mesh:
    p_sh, o_sh = shd.train_state_shardings(
        cfg, mesh, jax.eval_shape(lambda: params), jax.eval_shape(lambda: opt))
    b_sh = shd.named(mesh, shd.batch_specs(cfg, mesh, cell))
    jstep = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
    for tag, lab in (("", labels), ("masked_", masked)):
        p_out, _, m_out = jstep(params, opt, {"tokens": tokens, "labels": lab})
        meta[tag + "loss"] = float(m_out["loss"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(p_out)[0]:
            out[tag + "new" + jax.tree_util.keystr(path)] = np.asarray(leaf)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["init" + jax.tree_util.keystr(path)] = np.asarray(leaf)
out["tokens"] = np.asarray(tokens)
out["labels"] = np.asarray(labels)
out["masked"] = np.asarray(masked)
np.savez(sys.argv[1], **out)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(meta, f)
"""


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard8") / "ref.npz"
    cases = {"layouts": LAYOUTS, "constraints": CONSTRAINTS, "kv": KV_CACHES}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out), json.dumps(cases)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out)), json.loads(Path(str(out) + ".json").read_text())


def _spec(entries):
    return shd.P(*[tuple(e) if isinstance(e, list) else e for e in entries])


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
def test_pieces_equal_the_reference_addressable_shards(ref8, case):
    arrays, meta = ref8
    shape, axes, xshape, spec = LAYOUTS[case]
    mesh = make_test_mesh(shape, axes, device="cpu")
    x = torch.arange(int(np.prod(xshape)), dtype=torch.float32).reshape(xshape)
    st = shd.shard(x, mesh, _spec(spec))
    assert len(st.pieces) == mesh.size and st.shape == tuple(xshape)
    for k in range(mesh.size):
        want = meta[f"layout{case}_{k}"]
        got = [list(sl.indices(n)[:2]) for sl, n in zip(st.slices(k), xshape)]
        assert got == want, (k, got, want)
        np.testing.assert_array_equal(st.pieces[k].numpy(), arrays[f"layout{case}_{k}"])
    assert torch.equal(shd.gather(st), x)


def _resolved(spec):
    """A resolution as JAX spells an output's spec: one-name tuples as the
    name, trailing Nones dropped."""
    out = [e[0] if isinstance(e, (list, tuple)) and len(e) == 1 else
           (tuple(e) if isinstance(e, (list, tuple)) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("case", range(len(CONSTRAINTS)))
def test_constrain_resolves_as_the_reference(ref8, case):
    _, meta = ref8
    shape, axes, xshape, spec = CONSTRAINTS[case]
    mesh = make_test_mesh(shape, axes, device="cpu")
    axes_ = [tuple(e) if isinstance(e, list) else e for e in spec]
    x = torch.ones(xshape)
    assert shd.constraint_spec(xshape, *axes_) is None  # no ambient mesh
    with mesh, shd.constraint_log() as log:
        assert current_mesh() is mesh
        assert shd.constrain(x, *axes_) is x
    assert current_mesh() is None
    (logged_shape, got), = log
    assert logged_shape == tuple(xshape)
    assert got == shd.constraint_spec(xshape, *axes_, mesh=mesh)
    assert _resolved(got) == _resolved(meta[f"constrain{case}"])


@pytest.mark.parametrize("case", range(len(KV_CACHES)))
def test_kv_cache_constraint_resolves_as_the_reference(ref8, case):
    _, meta = ref8
    shape, axes, xshape = KV_CACHES[case]
    mesh = make_test_mesh(shape, axes, device="cpu")
    x = torch.ones(xshape)
    with mesh, shd.constraint_log() as log:
        assert shd.kv_cache_constraint(x, xshape[2], xshape[3]) is x
    (_, got), = log
    assert got == shd.kv_cache_spec(xshape, xshape[2], xshape[3], mesh=mesh)
    assert _resolved(got) == _resolved(meta[f"kv{case}"])


def _nest(flat: dict, prefix: str) -> dict:
    """Nested dicts from ``jax.tree_util.keystr`` keys under ``prefix``."""
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "["):
            continue
        path = re.findall(r"\['([^']+)'\]", key[len(prefix):])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.as_tensor(arr)
    return tree


def _glm_cfg():
    _, cfg = smoke("glm4-9b", activation_dtype="float32")
    return cfg


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(adamw.tree_leaves(a), adamw.tree_leaves(b)))


@pytest.mark.parametrize("labels", ["labels", "masked"])
def test_sharded_train_step_holds_the_reference_sharded_step(ref8, labels):
    """The reference test's step, its params drawn by the reference: the
    port's (2, 2) sharded step against the reference's jitted sharded
    step.  With masked labels the two groups count different tokens, and
    both packages divide by the global count (not a group's mean)."""
    arrays, meta = ref8
    cfg = _glm_cfg()
    params = _nest(arrays, "init")
    batch = {"tokens": torch.as_tensor(arrays["tokens"]),
             "labels": torch.as_tensor(arrays[labels])}
    mesh = make_test_mesh((2, 2), device="cpu")
    sp, so = spmd.shard_train_state(params, adamw.adamw_init(params), cfg, mesh)
    new, _, m = spmd.make_sharded_train_step(cfg, mesh, adamw.AdamWConfig(**OPT))(
        sp, so, batch)
    tag = "masked_" if labels == "masked" else ""
    assert abs(float(m["loss"]) - meta[tag + "loss"]) < 1e-4
    want = _nest(arrays, tag + "new")
    for a, b in zip(adamw.tree_leaves(shd.gather_tree(new)), adamw.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-5)
    if labels == "masked":
        # the mean of the two groups' means is another number
        _, _, mb = tstep.make_train_step(cfg, adamw.AdamWConfig(**OPT), microbatches=2)(
            params, adamw.adamw_init(params), batch)
        assert abs(float(mb["loss"]) - meta[tag + "loss"]) > 1e-3


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-370m", "mixtral-8x7b", "hymba-1.5b"])
def test_sharded_train_step_equals_the_unsharded_step(arch):
    """Dense, SSM and hybrid: one dp group's rows are one microbatch, so
    the (2, 2) sharded step equals ``microbatches=2`` bit for bit; MoE
    routes over the global batch, so it equals ``microbatches=1``."""
    rcfg, cfg = smoke(arch, activation_dtype="float32")
    _, params = carried_params(rcfg)
    rng = np.random.default_rng(3)
    S = 32 - cfg.prefix_len
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, S)), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.as_tensor(
            rng.normal(0, 0.02, (4, cfg.prefix_len, cfg.d_model)), dtype=torch.float32)
    opt = adamw.AdamWConfig(**OPT)
    want_p, want_o, want_m = tstep.make_train_step(
        cfg, opt, microbatches=1 if cfg.n_experts else 2)(params, adamw.adamw_init(params),
                                                         batch)
    mesh = make_test_mesh((2, 2), device="cpu")
    sp, so = spmd.shard_train_state(params, adamw.adamw_init(params), cfg, mesh)
    new, new_o, m = spmd.make_sharded_train_step(cfg, mesh, opt)(sp, so, batch)
    assert torch.equal(m["loss"], want_m["loss"])
    assert torch.equal(m["grad_norm"], want_m["grad_norm"])
    assert _equal_trees(shd.gather_tree(new), want_p)
    assert _equal_trees(shd.gather_tree(new_o.m), want_o.m)
    assert _equal_trees(shd.gather_tree(new_o.v), want_o.v)
    assert int(shd.gather(new_o.step)) == 1
    # every shard owns exactly its slice of the new state
    for leaf in adamw.tree_leaves(new):
        whole = shd.gather(leaf)
        for k in range(mesh.size):
            assert torch.equal(leaf.pieces[k], whole[leaf.slices(k)])


def test_sharded_train_step_with_microbatches_equals_the_unsharded_step():
    """Microbatches of the global batch, each cut over the dp groups:
    2 microbatches on (2, 2) equal 4 unsharded microbatches, bit for bit."""
    rcfg, cfg = smoke("smollm-135m", activation_dtype="float32")
    _, params = carried_params(rcfg)
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 16)), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    opt = adamw.AdamWConfig(**OPT)
    want_p, _, want_m = tstep.make_train_step(cfg, opt, microbatches=4)(
        params, adamw.adamw_init(params), batch)
    mesh = make_test_mesh((2, 2), device="cpu")
    sp, so = spmd.shard_train_state(params, adamw.adamw_init(params), cfg, mesh)
    new, _, m = spmd.make_sharded_train_step(cfg, mesh, opt, microbatches=2)(sp, so, batch)
    assert torch.equal(m["loss"], want_m["loss"])
    assert _equal_trees(shd.gather_tree(new), want_p)


@pytest.mark.parametrize("arch,batch", [("smollm-135m", 4), ("smollm-135m", 1),
                                        ("mamba2-370m", 2), ("hymba-1.5b", 2)])
def test_sharded_prefill_and_decode_equal_the_unsharded_port(arch, batch):
    """Prefill and 4 greedy decode steps on (2, 2) with the cache in its
    spec's pieces: smollm's one kv head takes the context-parallel form,
    its sequence over "model" (batch 4) or over ("data", "model")
    (batch 1)."""
    rcfg, cfg = smoke(arch, activation_dtype="float32")
    _, params = carried_params(rcfg)
    rng = np.random.default_rng(5)
    S = 32
    inputs = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, S - cfg.prefix_len)), dtype=torch.int32)}
    cache = lm.init_cache(cfg, batch, S + 8, "cpu")
    mesh = make_test_mesh((2, 2), device="cpu")
    sp = spmd.shard_params(params, cfg, mesh)
    sc = spmd.shard_cache(cache, cfg, mesh)
    if arch == "smollm-135m":
        seq = "model" if batch == 4 else ("data", "model")
        assert sc["k"].spec[2] == seq and sc["k"].spec[3] is None
    rows = batch // (2 if batch % 2 == 0 else 1)
    tol = dict(rtol=0, atol=0) if rows >= 2 or batch == 1 else dict(
        rtol=ONE_ROW_TOL, atol=ONE_ROW_TOL)
    want_l, want_c = lm.prefill(params, cfg, inputs["tokens"], cache)
    got_l, got_c = spmd.make_sharded_prefill_step(cfg, mesh)(sp, sc, inputs)
    decode = spmd.make_sharded_decode_step(cfg, mesh)
    tok_w = want_l.argmax(-1)[:, None].to(torch.int32)
    tok_g = got_l.argmax(-1)[:, None].to(torch.int32)
    for _ in range(4):
        torch.testing.assert_close(got_l, want_l, **tol)
        for k in want_c:
            assert got_c[k].spec == sc[k].spec
            torch.testing.assert_close(shd.gather(got_c[k]), want_c[k], **tol)
        assert torch.equal(tok_g, tok_w)
        want_l, want_c = lm.decode_step(params, cfg, tok_w, want_c)
        got_l, got_c = decode(sp, got_c, tok_g)
        tok_w = want_l.argmax(-1)[:, None].to(torch.int32)
        tok_g = got_l.argmax(-1)[:, None].to(torch.int32)
    assert torch.equal(tok_g, tok_w)


def test_model_call_sites_resolve_under_a_mesh():
    """Under ``with mesh:`` the forward's constraints resolve (the
    embeddings' batch, the residual between layers, the logits' vocab)
    and the values are those of the forward without a mesh."""
    rcfg, cfg = smoke("mixtral-8x7b", activation_dtype="float32")
    _, params = carried_params(rcfg)
    tokens = torch.zeros(4, 16, dtype=torch.int32)
    want, _ = lm.forward(params, cfg, tokens)
    mesh = make_test_mesh((2, 2), device="cpu")
    with mesh, shd.constraint_log() as log:
        got, _ = lm.forward(params, cfg, tokens)
    assert torch.equal(got, want)
    specs = [s for _, s in log]
    assert specs[0] == shd.P("data", None, None)
    assert specs[-1] == shd.P("data", None, "model")
    assert specs.count(shd.P("data", "model", None)) == cfg.n_layers  # seq_parallel


def test_shard_refuses_uneven_pieces_and_meshes_check_their_devices():
    mesh = make_test_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="uneven"):
        shd.shard(torch.zeros(3, 4), mesh, shd.P("data"))
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh((2, 2), ("data", "model"), [torch.device("cpu")] * 3)
    assert mesh.coords(3) == {"data": 1, "model": 1} and mesh.shard_at(data=1) == 2


def _train_state(cfg, params):
    return {"params": params, "opt": adamw.adamw_init(params)}


def test_restore_remeshes_a_sharded_checkpoint(tmp_path):
    """Saved from (2, 2), restored onto (4, 1) and onto one shard, bit for
    bit; the file equals an unsharded save key for key; on each mesh one
    step from the restored state equals one step from the saved state
    laid out there directly."""
    rcfg, cfg = smoke("smollm-135m", activation_dtype="float32")
    _, params = carried_params(rcfg)
    opt = adamw.AdamWConfig(**OPT)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 16)),
                             dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    m22 = make_test_mesh((2, 2), device="cpu")
    sp, so = spmd.shard_train_state(params, adamw.adamw_init(params), cfg, m22)
    sp, so, _ = spmd.make_sharded_train_step(cfg, m22, opt)(sp, so, batch)
    state = {"params": sp, "opt": so}
    ckpt.save(tmp_path / "sharded", 1, state)
    plain = {"params": shd.gather_tree(sp),
             "opt": adamw.OptState(shd.gather(so.step), shd.gather_tree(so.m),
                                   shd.gather_tree(so.v))}
    ckpt.save(tmp_path / "plain", 1, plain)
    a = np.load(tmp_path / "sharded" / "step_000000001" / "arrays.npz")
    b = np.load(tmp_path / "plain" / "step_000000001" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    for shape in ((4, 1), (1, 1)):
        mesh = make_test_mesh(shape, device="cpu")
        p_sh, o_sh = shd.train_state_shardings(cfg, mesh, plain["params"], None)
        got = ckpt.restore(tmp_path / "sharded", 1, state,
                           shardings={"params": p_sh, "opt": o_sh})
        assert got["params"]["embed"].mesh is mesh
        assert _equal_trees(shd.gather_tree(got["params"]), plain["params"])
        assert _equal_trees(shd.gather_tree(got["opt"].m), plain["opt"].m)
        assert int(shd.gather(got["opt"].step)) == 1
        step = spmd.make_sharded_train_step(cfg, mesh, opt)
        p2, _, m2 = step(got["params"], got["opt"], batch)
        direct = spmd.shard_train_state(plain["params"], plain["opt"], cfg, mesh)
        p1, _, m1 = step(*direct, batch)
        assert torch.equal(m2["loss"], m1["loss"])
        assert _equal_trees(shd.gather_tree(p2), shd.gather_tree(p1))


def test_a_reference_checkpoint_restores_onto_a_port_mesh(tmp_path):
    """A reference-written train state lands on a (2, 2) port mesh in its
    specs' pieces."""
    rcfg, cfg = smoke("glm4-9b", activation_dtype="float32")
    ref_params, params = carried_params(rcfg)
    from repro.optim import adamw as ref_adamw

    ref_ckpt.save(tmp_path, 3, {"params": ref_params, "opt": ref_adamw.adamw_init(ref_params)})
    mesh = make_test_mesh((2, 2), device="cpu")
    like = _train_state(cfg, params)
    p_sh, o_sh = shd.train_state_shardings(cfg, mesh, params, None)
    got = ckpt.restore(tmp_path, 3, like, shardings={"params": p_sh, "opt": o_sh})
    wq = got["params"]["layers"]["attn"]["wq"]
    assert wq.spec == shd.param_specs(cfg, mesh, params)["layers"]["attn"]["wq"]
    assert _equal_trees(shd.gather_tree(got["params"]),
                        lm.params_from_numpy(to_numpy(ref_params), "cpu"))
