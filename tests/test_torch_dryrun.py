"""The HLO tooling's torch form: ``repro_torch.hlocount``, the roofline
readers and ``launch.dryrun`` against the reference's ``repro.hlocount``,
``repro.roofline`` and ``repro.launch.dryrun``.

``hlocount.analyze`` counts a torch program's operation stream (real or
``meta`` tensors) by the reference's rules: the reference's scan test as
a 13-step Python loop gives exactly its dot flops, and glm4-9b's smoke
forward the dot flops of the reference's ``analyze_hlo`` on its compiled
forward (one CPU device).  Collective wire bytes follow the reference's
per-kind formulas on its synthetic all-reduce and all-gather.  The dry
run's model flops equal the reference's for every (arch, cell); its
cells run on ``meta`` and end ``ok`` or the reference's ``skipped``;
the per-shard state bytes equal the sum, over the reference's own spec
trees, of each leaf's bytes over its sharded axes' sizes.
"""
import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lm import ARCHS
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import cell_applicable as ref_cell_applicable
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs import viterbi_k7 as ref_vit
from repro.distributed import sharding as ref_shd
from repro.hlocount import analyze_hlo
from repro.models import lm as ref_lm
from repro import roofline as ref_roofline
from repro_torch import hlocount, roofline
from repro_torch.configs import SHAPE_CELLS, get_config, get_smoke_config
from repro_torch.configs import viterbi_k7 as vit
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.obs import profile
from repro_torch.optim.adamw import AdamWConfig, adamw_init

SYN_HLO = """
HloModule m
ENTRY %main (a: f32[64,128]) -> f32[64,128] {
  %a = f32[64,128]{1,0} parameter(0)
  %ar = f32[64,128]{1,0} all-reduce(%a), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = bf16[64,256]{1,0} all-gather(%a), replica_groups=[1,8]<=[8], dimensions={1}
  ROOT %out = f32[64,128]{1,0} add(%ar, %ar)
}
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  It sets XLA_FLAGS for 512 host
    devices when imported; JAX is up already here, and the variable is
    put back so that no later subprocess inherits it."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_loop_dot_flops_are_exact(device):
    """The reference's scan test (tests/test_distributed.py:56-77) as a
    13-step Python loop: 2 x 8 x 64 x 64 x 13 dot flops."""
    x = torch.zeros(8, 64, device=device)
    w = torch.zeros(64, 64, device=device)

    def f(x, w):
        c = x
        for _ in range(13):
            c = torch.tanh(c @ w)
        return c.sum()

    cost = hlocount.analyze(f, x, w)
    assert cost.dot_flops == 2 * 8 * 64 * 64 * 13
    assert cost.flops == cost.dot_flops + 13 * 8 * 64 + 8 * 64  # tanh, the sum
    assert not cost.unknown_ops
    assert cost.op_counts["mm"] == 13


@pytest.mark.parametrize("arch", ["glm4-9b", "smollm-135m"])
def test_forward_dot_flops_equal_the_reference_hlo(arch):
    """A smoke forward at 2 x 32, f32: the port's operation stream on
    ``meta`` against the reference's ``analyze_hlo`` of its compiled
    forward; the same count on CPU tensors."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), activation_dtype="float32")
    shapes = jax.eval_shape(lambda: ref_lm.init_params(rcfg, jax.random.PRNGKey(0)))
    compiled = jax.jit(lambda p, t: ref_lm.forward(p, rcfg, t)).lower(
        shapes, jax.ShapeDtypeStruct((2, 32), jnp.int32)).compile()
    want = analyze_hlo(compiled.as_text()).dot_flops
    cfg = dataclasses.replace(get_smoke_config(arch), activation_dtype="float32")
    for dev in ("meta", "cpu"):
        params = lm.init_params(cfg, device=dev)
        tokens = torch.zeros(2, 32, dtype=torch.int32, device=dev)
        cost = hlocount.analyze(lm.forward, params, cfg, tokens)
        assert cost.dot_flops == want, (dev, cost.dot_flops, want)


def test_collective_wire_bytes_follow_the_reference():
    """The reference's synthetic all-reduce (f32[64,128], groups of 4) and
    all-gather (bf16[64,256], 8), made as the port's records."""
    def collectives():
        shd.record_collective("all-reduce", 4, torch.empty(64, 128, device="meta"))
        shd.record_collective("all-gather", 8,
                              torch.empty(64, 256, dtype=torch.bfloat16, device="meta"))

    cost = hlocount.analyze(collectives)
    ref_cost = analyze_hlo(SYN_HLO)
    assert cost.wire_bytes == pytest.approx(ref_cost.wire_bytes)
    assert cost.coll_counts == ref_cost.coll_counts
    ops = roofline.parse_collectives(cost)
    ref_ops = ref_roofline.parse_collectives(SYN_HLO)
    assert sorted((o.kind, o.group_size, o.result_bytes) for o in ops) == sorted(
        (o.kind, o.group_size, o.result_bytes) for o in ref_ops)
    assert roofline.collective_wire_bytes(cost) == pytest.approx(
        ref_roofline.collective_wire_bytes(SYN_HLO))
    for kind in ("all-reduce", "all-gather", "all-to-all", "collective-permute"):
        op = roofline.CollectiveOp(kind, "f32", (8,), 4, 32)
        ref = ref_roofline.CollectiveOp(kind, "f32", (8,), 4, 32)
        assert op.wire_bytes == ref.wire_bytes
    # reduce-scatter: the result is the shard, so a ring sends (g - 1)
    # shards, hlocount's formula; the reference's CollectiveOp divides by g
    # once more (ROADMAP R13)
    op = roofline.CollectiveOp("reduce-scatter", "f32", (8,), 4, 32)
    assert op.wire_bytes == 3 * 32
    assert ref_roofline.CollectiveOp("reduce-scatter", "f32", (8,), 4, 32).wire_bytes == 24


def test_sharded_step_counts_are_affine_in_depth():
    """The dry run counts depths 1 and 2 and carries them to the config's
    depth (``hlocount.affine``): equal to the direct count at depth 4."""
    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), activation_dtype="float32")
    mesh = make_test_mesh((2, 2), device="meta")
    batch = {"tokens": torch.zeros(4, 32, dtype=torch.int32, device="meta"),
             "labels": torch.zeros(4, 32, dtype=torch.int32, device="meta")}

    def count(n_layers):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        params = lm.init_params(c, device="meta")
        sp, so = spmd.shard_train_state(params, adamw_init(params), c, mesh)
        step = spmd.make_sharded_train_step(c, mesh, AdamWConfig(), microbatches=2)
        return hlocount.analyze(step.shard_program, sp, so, batch)

    got = hlocount.affine(count(1), count(2), 4)
    want = count(4)
    for field in ("flops", "bytes", "dot_flops", "wire_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.coll_counts == want.coll_counts
    assert got.op_counts == want.op_counts
    # one gather a parameter leaf cut in pieces (final_norm is replicated);
    # one reduction a gradient leaf and one a microbatch's token count
    params = lm.init_params(cfg, device="meta")
    n_cut = sum(st.n_pieces > 1 for st in shd._leaves(spmd.shard_params(params, cfg, mesh)))
    n_leaves = len(shd._leaves(params))
    assert want.coll_counts == {"all-gather": n_cut, "all-reduce": n_leaves + 2}


def test_roofline_analyze_prices_a_cost():
    cost = hlocount.HloCost(flops=67e12, bytes=3.35e12 / 2, collectives=[
        {"kind": "all-reduce", "group_size": 2, "dtype": "float32", "shape": (4,),
         "result_bytes": 900e9}], coll_counts={"all-reduce": 1})
    rep = roofline.analyze("a", "c", "m", 4, cost, 4 * 67e12,
                           memory_stats={"argument_bytes": 7, "temp_bytes": None})
    assert rep.t_compute == pytest.approx(1.0) and rep.t_memory == pytest.approx(0.5)
    assert rep.t_collective == pytest.approx(1.0) and rep.bottleneck == "compute"
    assert rep.mfu == pytest.approx(1.0)
    assert rep.to_dict()["memory_stats"]["argument_bytes"] == 7


def test_trip_counts_and_measured_depth_are_not_mapped():
    with pytest.raises(NotImplementedError, match="trip counts"):
        hlocount.max_trip_count("")
    with pytest.raises(NotImplementedError, match="trip counts"):
        hlocount.total_trip_count("")
    with pytest.raises(NotImplementedError, match="inside its kernels"):
        profile.measured_depth(lambda x: x, torch.zeros(2))


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(ref_dryrun, arch, cell):
    assert dryrun.model_flops(get_config(arch), SHAPE_CELLS[cell]) == \
        ref_dryrun.model_flops(ref_get_config(arch), REF_CELLS[cell])


@pytest.mark.parametrize("cell", list(vit.VITERBI_CELLS))
def test_viterbi_model_flops_equal_the_reference(ref_dryrun, cell):
    assert dryrun.viterbi_model_flops(vit.config_for_cell(cell), vit.VITERBI_CELLS[cell]) == \
        ref_dryrun.viterbi_model_flops(ref_vit.config_for_cell(cell),
                                       ref_vit.VITERBI_CELLS[cell])
    assert [c for _, c in dryrun.iter_cells("viterbi-k7")] == [
        c for _, c in ref_dryrun.iter_cells("viterbi-k7")]


class _StandIn:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _spec_bytes(shape, dtype_bytes, spec, mesh) -> int:
    n = math.prod(shape) * dtype_bytes
    for ax in spec:
        if ax is not None:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n //= mesh.shape.get(a, 1)
    return n


@functools.lru_cache(maxsize=None)
def _ref_state_bytes(arch, cell_name, multi_pod):
    """Per-shard state bytes from the reference's spec trees."""
    cfg = ref_get_config(arch)
    cell = REF_CELLS[cell_name]
    mesh = (_StandIn((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else _StandIn((16, 16), ("data", "model")))
    shapes = jax.eval_shape(lambda: ref_lm.init_params(cfg, jax.random.PRNGKey(0)))
    specs = ref_shd._fix_divisibility(ref_shd.param_specs(cfg, mesh, shapes), shapes, mesh)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    pairs = zip(jax.tree.leaves(specs, is_leaf=is_spec), jax.tree.leaves(shapes))
    p_bytes = sum(_spec_bytes(s.shape, s.dtype.itemsize, sp, mesh) for sp, s in pairs)
    if cell.kind == "train":  # params, m and v (f32, the param specs), the step
        return 3 * p_bytes + 4
    cache = ref_lm.cache_specs(cfg, cell.global_batch, cell.seq_len)
    cspecs = ref_shd.cache_partition_specs(cfg, mesh, cell.global_batch)
    return p_bytes + sum(_spec_bytes(cache[k].shape, cache[k].dtype.itemsize, cspecs[k], mesh)
                         for k in cache)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b"])
def test_run_cell_on_meta(arch, cell, multi_pod):
    rec = dryrun.run_cell(arch, cell, multi_pod)
    want = "ok" if ref_cell_applicable(ref_get_config(arch), REF_CELLS[cell]) else "skipped"
    assert rec["status"] == want, rec.get("error")
    assert rec["mesh"] == dryrun.mesh_name(multi_pod)
    assert rec["n_chips"] == (512 if multi_pod else 256)
    if want == "skipped":
        return
    assert rec["memory_stats"]["argument_bytes"] == _ref_state_bytes(arch, cell, multi_pod)
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert rec["wire_bytes_per_device"] > 0 and rec["collective_counts"]["all-gather"] > 0
    assert not rec["unknown_ops"], rec["unknown_ops"]
    if SHAPE_CELLS[cell].kind == "train":
        # the model axis splits no compute: per shard, about 1/dp of the
        # global count, which is at least the model flops
        assert rec["flops_per_device"] * (32 if multi_pod else 16) > rec["model_flops"]


def test_main_writes_only_under_out(tmp_path, capsys):
    assert dryrun.main(["--arch", "viterbi-k7", "--mesh", "both"]) == 0
    assert "12 ok, 0 skipped, 0 failed" in capsys.readouterr().out
    assert dryrun.main(["--arch", "smollm-135m", "--cell", "long_500k", "--mesh", "multi",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "2pod-2x16x16" / "smollm-135m__long_500k.json").read_text())
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert dryrun.main(["--arch", "viterbi-k7", "--mesh", "single", "--jobs", "2",
                        "--out", str(tmp_path), "--skip-existing"]) == 0
    assert len(list((tmp_path / "1pod-16x16").iterdir())) == len(vit.VITERBI_CELLS)
