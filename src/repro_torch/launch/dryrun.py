"""Multi-pod dry run: count every (arch x shape x mesh) cell's per-shard
program and price it on a roofline, the port of the reference's
``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --cell train_4k --out DIR

The reference forces 512 host devices and lowers and compiles each cell
for a TPU pod, never running it.  The port's form of that is the
``meta`` device (``--device``, default ``meta``): every shard of
``make_production_mesh`` lies there, nothing is allocated or computed,
and it is not a CPU fallback.  Each LM cell lays its state out per the
sharding rules (``distributed/sharding.py``), builds the sharded train,
prefill or decode step (``distributed/spmd.py``; train at 4
microbatches, as the reference's) and counts shard 0's program with
``hlocount.analyze``; ``roofline.analyze`` prices it on
``roofline.H100``, with the per-shard state bytes from the specs in
place of ``memory_analysis()``'s argument bytes (its temp bytes are not
mapped on ``meta``).  The ``model`` axis shards storage, not a matmul's
compute (``distributed/spmd.py``), so a cell's per-shard operations are
its global count over the dp size, not over the shard count.

Each Viterbi cell prices one shard's streams with ``kernels/traffic.py``'s
static model and ``viterbi_model_flops``: its kernels do not run on
``meta``.  The streams go over the largest axis prefix that divides the
batch, as the reference's serve step shards them.

Nothing is written into the repository: ``--out DIR`` writes one JSON
record a cell under ``DIR/<mesh>/``; without it, nothing is written.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import pathlib
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import torch

from repro_torch import hlocount, roofline
from repro_torch.configs import (
    ALL_IDS,
    SHAPE_CELLS,
    cell_applicable,
    get_config,
    input_specs,
)
from repro_torch.configs import viterbi_k7 as vit
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["mesh_name", "model_flops", "viterbi_model_flops", "run_cell",
           "iter_cells", "main"]

TRAIN_MICROBATCHES = 4  # 256-row global batch -> 64 rows a grad-accum step


def mesh_name(multi_pod: bool) -> str:
    return "2pod-2x16x16" if multi_pod else "1pod-16x16"


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS convention: 6*N*D for train (N = active params for
    MoE), 2*N*D for forward-only inference."""
    n = cfg.n_active_params() if cfg.n_experts else cfg.n_params()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token per stream


def viterbi_model_flops(vcfg, cell) -> float:
    """Useful ACS work: per stage per state, 2^rho predecessors x
    (branch-metric MACs + add + compare).  Standard cells adjust the stage
    count for puncturing (stream_len counts KEPT serial LLRs) and for the
    WAVA circulations of tail-biting cells."""
    from repro_torch.codes.registry import get_code
    from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS

    spec, rho = vcfg.spec, vcfg.rho
    S, R, B = spec.n_states, 1 << rho, rho * spec.beta
    code = get_code(getattr(cell, "code", "ccsds-k7"))
    if code.termination == "tailbiting":
        stages = cell.stream_len * DEFAULT_WAVA_ITERS  # batch WAVA passes
    else:
        n, v = _open_tiling(vcfg, cell, code)
        n_windows = -(-n // vcfg.frame_len)  # tiled_decode_stream ceils
        stages = n_windows * (vcfg.frame_len + 2 * v)
    steps = stages / rho
    per_step = S * R * (2 * B + 2)
    return cell.batch_streams * steps * per_step


def _open_tiling(vcfg, cell, code):
    """(stages a stream, overlap) of an open-trellis cell's tiled decode:
    punctured cells count kept serial LLRs and tile with the
    erasure-stretched overlap."""
    n, v = cell.stream_len, vcfg.overlap
    if code.puncture is not None:
        n = code.puncture.stages_for(cell.stream_len)
        v = int(v * code.puncture.expansion)
        v += (-v) % vcfg.rho
    return n, v


def _stream_axes(mesh, n_streams: int):
    """The largest prefix of (dp axes..., model) whose size divides the
    stream count: the axes the reference's serve step shards streams on."""
    axes = list(dp_axes(mesh)) + ["model"]
    while axes and n_streams % math.prod(mesh.shape[a] for a in axes):
        axes.pop()
    return tuple(axes)


def _viterbi_cell(vcfg, cell, mesh):
    """(flops, bytes) of one shard's streams, and the shard count they
    split over."""
    from repro_torch.codes.registry import get_code
    from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS
    from repro_torch.kernels import traffic

    code = get_code(cell.code)
    size = math.prod(mesh.shape[a] for a in _stream_axes(mesh, cell.batch_streams))
    streams = cell.batch_streams // size
    kw = dict(spec=vcfg.spec, rho=vcfg.rho, precision=vcfg.precision, xla="static")
    if code.termination == "tailbiting":
        # WAVA decodes whole blocks: K1 writes phi, a traceback reads it,
        # once a circulation
        one = traffic.two_pass_stream_traffic(
            cell.stream_len, streams, decision_depth=vcfg.rho,
            pack_survivors=vcfg.pack_survivors, **kw)
        nbytes = DEFAULT_WAVA_ITERS * one.total
    else:
        n, v = _open_tiling(vcfg, cell, code)
        windows = streams * -(-n // vcfg.frame_len)
        nbytes = traffic.one_pass_stream_traffic(
            vcfg.frame_len + 2 * v, windows, decision_depth=v,
            pack_survivors=True, **kw).total
    return viterbi_model_flops(vcfg, cell) / size, nbytes, size


def _meta_batch(cfg, cell, device):
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in input_specs(cfg, cell).items()}


def _lm_cell(cfg, cell, mesh):
    """(HloCost of shard 0's program, shard 0's state bytes), the cost
    counted at depths 1 and 2 and carried to ``cfg.n_layers``
    (``hlocount.affine``): the layers are identical, stacked on a leading
    axis that no spec shards, so every count is affine in the depth.
    The state bytes are the full config's."""
    c1, _ = _lm_cell_at(dataclasses.replace(cfg, n_layers=1), cell, mesh)
    c2, _ = _lm_cell_at(dataclasses.replace(cfg, n_layers=2), cell, mesh)
    return hlocount.affine(c1, c2, cfg.n_layers), _state_bytes(cfg, cell, mesh)


def _state_bytes(cfg, cell, mesh) -> int:
    """Shard 0's bytes of the cell's state, from the specs."""
    dev = mesh.devices[0]
    params = lm.init_params(cfg, device=dev)
    if cell.kind == "train":
        sp, so = spmd.shard_train_state(params, adamw_init(params), cfg, mesh)
        return spmd.shard_bytes(sp) + spmd.shard_bytes(so)
    cache = lm.init_cache(cfg, cell.global_batch, cell.seq_len, dev)
    return (spmd.shard_bytes(spmd.shard_params(params, cfg, mesh))
            + spmd.shard_bytes(spmd.shard_cache(cache, cfg, mesh)))


def _lm_cell_at(cfg, cell, mesh):
    """(HloCost of shard 0's program, shard 0's state bytes) at
    ``cfg``'s own depth."""
    dev = mesh.devices[0]
    params = lm.init_params(cfg, device=dev)
    batch = _meta_batch(cfg, cell, dev)
    if cell.kind == "train":
        sp, so = spmd.shard_train_state(params, adamw_init(params), cfg, mesh)
        step = spmd.make_sharded_train_step(cfg, mesh, AdamWConfig(),
                                            microbatches=TRAIN_MICROBATCHES)
        cost = hlocount.analyze(step.shard_program, sp, so, batch)
        return cost, spmd.shard_bytes(sp) + spmd.shard_bytes(so)
    del params  # the optimiser state is a train cell's only
    sp = spmd.shard_params(lm.init_params(cfg, device=dev), cfg, mesh)
    sc = spmd.shard_cache(lm.init_cache(cfg, cell.global_batch, cell.seq_len, dev),
                          cfg, mesh)
    if cell.kind == "prefill":
        step = spmd.make_sharded_prefill_step(cfg, mesh)
        cost = hlocount.analyze(step.shard_program, sp, sc, batch)
    else:
        step = spmd.make_sharded_decode_step(cfg, mesh)
        cost = hlocount.analyze(step.shard_program, sp, sc, batch["tokens"])
    return cost, spmd.shard_bytes(sp) + spmd.shard_bytes(sc)


def run_cell(arch: str, cell_name: str, multi_pod: bool,
             out_dir: Optional[pathlib.Path] = None, device="meta") -> dict:
    """One cell's record: the roofline report and ``status`` ok, the
    reference's ``skipped`` for long_500k on a full-attention arch, or
    ``failed`` with the error."""
    mesh = make_production_mesh(multi_pod, device=device)
    mname = mesh_name(multi_pod)
    rec = {"arch": arch, "cell": cell_name, "mesh": mname, "n_chips": mesh.size}
    t0 = time.perf_counter()
    try:
        if arch == "viterbi-k7":
            cell = vit.VITERBI_CELLS[cell_name]
            vcfg = vit.config_for_cell(cell_name)
            flops, nbytes, size = _viterbi_cell(vcfg, cell, mesh)
            report = roofline.RooflineReport(
                arch=arch, cell=cell_name, mesh=mname, n_chips=mesh.size,
                flops_per_device=flops, hbm_bytes_per_device=float(nbytes),
                wire_bytes_per_device=0.0, model_flops=viterbi_model_flops(vcfg, cell),
                collective_counts={}, memory_stats={"stream_shards": size})
        else:
            cfg = get_config(arch)
            cell = SHAPE_CELLS[cell_name]
            if not cell_applicable(cfg, cell):
                rec["status"] = "skipped"
                rec["reason"] = (
                    "long_500k requires sub-quadratic attention; "
                    f"{arch} is pure full-attention (DESIGN.md §4)"
                )
                return rec
            cost, state_bytes = _lm_cell(cfg, cell, mesh)
            report = roofline.analyze(
                arch, cell_name, mname, mesh.size, cost, model_flops(cfg, cell),
                memory_stats={"argument_bytes": state_bytes, "temp_bytes": None})
            rec["unknown_ops"] = list(cost.unknown_ops)
        rec.update(report.to_dict())
        rec["status"] = "ok"
        rec["count_s"] = round(time.perf_counter() - t0, 2)
        state = (report.memory_stats or {}).get("argument_bytes")
        print(f"[{mname}] {arch} x {cell_name}: OK ({rec['count_s']} s)"
              + (f" state={state / 2**30:.2f}GiB" if state is not None else "")
              + f" bottleneck={rec['bottleneck']}", flush=True)
    except Exception as e:  # noqa: BLE001 -- the record carries the failure
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{mname}] {arch} x {cell_name}: FAILED {rec['error'][:200]}", flush=True)
    finally:
        if out_dir is not None:
            out = pathlib.Path(out_dir) / mname
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{arch}__{cell_name}.json").write_text(
                json.dumps(rec, indent=1, default=str))
    return rec


def iter_cells(arch=None):
    for a in ([arch] if arch else ALL_IDS):
        for c in (vit.VITERBI_CELLS if a == "viterbi-k7" else SHAPE_CELLS):
            yield a, c


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=ALL_IDS + [None])
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write one JSON record a cell under OUT/<mesh>/")
    ap.add_argument("--device", default="meta",
                    help="where the shards lie: meta (default; allocates nothing), "
                         "cpu or cuda")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one worker process each")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = ([(args.arch, args.cell)] if args.arch and args.cell
             else list(iter_cells(args.arch)))
    out_dir = pathlib.Path(args.out) if args.out else None
    todo = []
    t0 = time.perf_counter()
    for multi_pod in meshes:
        for arch, cell in cells:
            if args.skip_existing and out_dir is not None:
                f = out_dir / mesh_name(multi_pod) / f"{arch}__{cell}.json"
                if f.exists() and json.loads(f.read_text()).get("status") in ("ok", "skipped"):
                    continue
            todo.append((arch, cell, multi_pod, out_dir, args.device))
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            results = [f.result() for f in [pool.submit(run_cell, *t) for t in todo]]
    else:
        results = [run_cell(*t) for t in todo]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "failed" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.perf_counter() - t0:.1f} s ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
