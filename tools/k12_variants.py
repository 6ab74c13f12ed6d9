"""K1's and K2's design choices measured side by side on one CUDA card:

    python3 tools/k12_variants.py

Builds ``csrc/acs_forward.cu`` and ``csrc/acs_decode_fused.cu`` several
ways, one ``nvcc`` each, side by side, into ``build/k12_variants/``:

  * ``as is``: this checkout's sources;
  * ``shuffle max``: ``frame_max`` of ``acs_step.cuh`` taking the
    five-level shuffle tree at 32 threads a frame too, where the source
    takes one ``redux.sync`` over integer keys;
  * ``chain sum`` (K1-LOGPROB): the logsumexp takes its max from the
    argmax chain and sums all R terms' expf in slot order (exp(0) = 1
    among them), where the source's ``reduce_slots`` finds the max by a
    tournament and sums 1 and the R - 1 others' expf (a different
    rounding: held within 1e-3 of the wrapper's metrics, not bit for bit);
  * ``one state a lane`` (K1 only): ``gather_nq`` gives one state a thread
    up to S = 512, so a frame of S = 64 is 64 threads over two warps (one
    frame a block; half the expf a lane, the frame's barrier and its max
    across the two warps), where the source gives two states a lane (one
    warp a frame);

and launches them through their C interfaces, so that the choices the
wrappers make (``kernel_geometry``) are made here instead:

  * ``renorm off`` (K1): no per-step renorm, which drops the frame max
    from the step's chain altogether (a different function; timed only);
  * ``rings in device memory`` (K2 at the streaming geometry): the rings
    and tile maps in the scratch buffer at the same four frames a block;
  * K2 at an int8 ring of 2,560 steps (ccsds-k7 at rho = 2 and 3, 512
    frames, one launch of 2,048 steps, tile 32): one frame a block with
    its ring in shared memory, against four a block with the rings in
    device memory; ``k2_block_frames`` picks the layout of fewer waves.

Shapes: K1 at decode_64k (512 frames x 32,768 radix steps of ccsds-k7,
rho = 2, integer LLRs), the recovery K1 (8,192 frames x 512 steps), K2
over the stream (16 launches of 2,048 steps, packed ring of 2,560 steps,
tile 32, four frames a block), K1-LOGPROB at 64 and 512 frames x 32,768
steps of half-scaled Gaussian LLRs (``as is``, ``one state a lane`` and
``chain sum``; 64 frames is ``forward_fused(semiring=LOGPROB)`` at the
soft cell's shape).  Each case runs every variant in turn, then again in
reverse order; prints each turn's mean time over 3 calls after a warm-up
(CUDA events), and holds each variant's outputs bit for bit to the
wrapper's (``viterbi_acs``) on the same inputs, except ``renorm off``
and ``chain sum``.  Needs one card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import CODE_K7_CCSDS, build_acs_tables  # noqa: E402
from repro_torch.core.kernel_geometry import (  # noqa: E402
    GATHER_GROUP_BUDGET, STAGE_STEPS, k1_smem_bytes, gather_stage_steps,
    k2_frame_bytes, k2_smem_bytes,
)
from repro_torch.kernels import viterbi_acs  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
REDUX_AT_32 = "  const int tpf = g.sh.tpf;\n  if (tpf < 32) {\n    for (int off = tpf / 2; off > 0; off >>= 1)\n      v = fmaxf("
SHUFFLE_AT_32 = REDUX_AT_32.replace("tpf < 32", "tpf <= 32")
TOURNAMENT = "      val[q] = reduce_slots<R, kLogprob>(pot);\n"
CHAIN = """      {
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) sum += expf(pot[r] - best);
        val[q] = best + log_of_sum(sum);
      }
"""
GATHER_NQ = "constexpr int gather_nq(int S) { return S >= 64 ? 2 : 1; }"
ONE_STATE_NQ = GATHER_NQ.replace("S >= 64", "S >= 1024")
NARROW_NQ1 = ("    if (gather_nq(S) == 1)\n"
              "      return fn(r, std::integral_constant<int, 1>{}, std::false_type{});\n")
ONE_STATE_NQ1 = ("    if (gather_nq(S) == 1 && S > 32)\n"
                 "      return fn(r, std::integral_constant<int, 1>{}, std::true_type{});\n"
                 + NARROW_NQ1)
F_64K, T_64K = 512, 32768
F_SOFT = 64
CHUNK, DEPTH, TILE = 2048, 2560, 32
F_REC, T_REC = 8192, 512


def variant_sources():
    hdr = (CSRC / "acs_step.cuh").read_text()
    assert hdr.count(REDUX_AT_32) == 1 and hdr.count(TOURNAMENT) == 1
    assert hdr.count(GATHER_NQ) == 1 and hdr.count(NARROW_NQ1) == 1
    both = ("acs_forward", "acs_decode_fused")
    return {"as is": (hdr, both),
            "shuffle max": (hdr.replace(REDUX_AT_32, SHUFFLE_AT_32), both),
            "chain sum": (hdr.replace(TOURNAMENT, CHAIN), ("acs_forward",)),
            "one state a lane": (hdr.replace(GATHER_NQ, ONE_STATE_NQ)
                                 .replace(NARROW_NQ1, ONE_STATE_NQ1), ("acs_forward",))}


def build(item):
    """One variant's libraries (K1, and K2 where it has one), each as
    ``viterbi_acs.build`` builds it."""
    variant, (hdr, names) = item
    d = ROOT / "build" / "k12_variants" / variant.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "acs_step.cuh").write_text(hdr)
    procs = {}
    for name in names:
        (d / f"{name}.cu").write_text((CSRC / f"{name}.cu").read_text())
        procs[name] = subprocess.Popen(
            [viterbi_acs._find_nvcc(), *viterbi_acs._NVCC_FLAGS, "-o",
             str(d / f"{name}.so"), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{variant} {name}: nvcc failed:\n{err}")
    return variant, {name: viterbi_acs.bind(d / f"{name}.so", name) for name in procs}


def cuda_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def check(lib, name, err):
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: launch failed ({err}: {msg})")


def one_state_layout(B, n_u):
    """(stage steps, shared bytes) of the ``one state a lane`` K1 block at
    S = 64: one frame, one group (``GroupSmem`` of csrc/acs_step.cuh at one
    frame a group, no origins), the stage halved past the group budget as
    ``kernel_geometry.gather_stage_steps`` halves it."""
    def group_bytes(ss):
        a16 = lambda n: -(-n // 16) * 16  # noqa: E731
        x = a16(a16(ss * B * 4) + ss * n_u * 4)
        red = a16(a16(x + 2 * 64 * 4) + ss * 64)
        return a16(red + 32 * 4)
    ss = STAGE_STEPS
    while ss > 1 and group_bytes(ss) > GATHER_GROUP_BUDGET:
        ss //= 2
    return ss, group_bytes(ss)


def k1(lib, blocks, lam0, ops, renorm=True, logprob=False, one_state=False):
    """K1 (S = 64, R = 4, int8 phi), tropical or at LOGPROB, at the
    wrapper's layout, or at ``one state a lane``'s (its library only)."""
    T, F, B = blocks.shape
    n_u = ops.cols.shape[1]
    ss, smem = (one_state_layout(B, n_u) if one_state else
                (gather_stage_steps(64, B, n_u, False), k1_smem_bytes(64, B, n_u)))
    lam = torch.empty((F, 64), device=blocks.device)
    phi = torch.empty((T, F, 64), dtype=torch.int8, device=blocks.device)
    check(lib, "acs_forward", lib.acs_forward_gather_launch(
        blocks.data_ptr(), lam0.data_ptr(), ops.cols.data_ptr(), ops.cid.data_ptr(),
        lam.data_ptr(), phi.data_ptr(), T, F, B, 64, 4, n_u, ss, 0, 0,
        int(renorm), 0, int(logprob), smem, torch.cuda.current_device(),
        torch.cuda.current_stream().cuda_stream))
    return lam, phi


def k2(lib, blocks, lam0, hist0, ops, rho, packed, bf, in_smem):
    """K2 (ccsds-k7, radix 2^rho, tile 32) at ``bf`` frames a block, its
    rings in shared memory or in a scratch buffer in device memory."""
    T, F, B = blocks.shape
    D, W = hist0.shape[0], hist0.shape[2]
    n_u = ops.cols.shape[1]
    dev = blocks.device
    bits = torch.empty((T * rho, F), dtype=torch.int8, device=dev)
    lam = torch.empty((F, 64), device=dev)
    hist = torch.empty((D, F, W), dtype=hist0.dtype, device=dev)
    ring = None
    if not in_smem:
        ring = torch.empty(-(-F // bf) * bf * k2_frame_bytes(64, D, TILE, packed),
                           dtype=torch.uint8, device=dev)
    check(lib, "acs_decode_fused", lib.acs_decode_fused_launch(
        blocks.data_ptr(), lam0.data_ptr(), hist0.data_ptr(), ops.cols.data_ptr(),
        ops.cid.data_ptr(), bits.data_ptr(), lam.data_ptr(), hist.data_ptr(),
        None if ring is None else ring.data_ptr(), 0 if ring is None else ring.numel(),
        T, F, B, 64, 1 << rho, n_u, gather_stage_steps(64, B, n_u, True), bf, D, TILE,
        7, rho, 0, 0, 1, int(packed),
        k2_smem_bytes(64, B, n_u, D, TILE, packed, bf, in_smem),
        torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream))
    return bits, lam, hist


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k12_variants: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(4) as pool:
        libs = dict(pool.map(build, variant_sources().items()))
    dev = torch.device("cuda")
    tables = {rho: build_acs_tables(CODE_K7_CCSDS, rho) for rho in (2, 3)}
    w = {rho: torch.as_tensor(tb.fused_w, device=dev) for rho, tb in tables.items()}
    ops = {rho: viterbi_acs.gather_operands(w[rho], tb.llr_block, 64, tb.n_slots)
           for rho, tb in tables.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    blocks = torch.randint(-16, 17, (T_64K, F_64K, 4), generator=gen, device=dev).float()
    lam0 = torch.full((F_64K, 64), -1e9, device=dev)
    lam0[:, 0] = 0.0
    rec = torch.randint(-16, 17, (T_REC, F_REC, 4), generator=gen, device=dev).float()
    entry = torch.randint(-64, 1, (F_REC, 64), generator=gen, device=dev).float()
    chunks = [blocks[lo:lo + CHUNK].contiguous() for lo in range(0, T_64K, CHUNK)]
    packed0 = torch.zeros((DEPTH, F_64K, 4), dtype=torch.int32, device=dev)
    int8_in = {
        rho: (torch.randint(-16, 17, (CHUNK, F_64K, 2 * rho), generator=gen,
                            device=dev).float(),
              torch.randint(0, 1 << rho, (DEPTH, F_64K, 64), generator=gen,
                            device=dev, dtype=torch.int8))
        for rho in (2, 3)
    }

    def stream(lib, bf, in_smem):
        lam, hist, out = lam0, packed0, []
        for cb in chunks:
            bits, lam, hist = k2(lib, cb, lam, hist, ops[2], 2, True, bf, in_smem)
            out.append(bits)
        return torch.cat(out), lam, hist

    def wrapper_stream():
        lam, hist, out = lam0, packed0, []
        for cb in chunks:
            bits, lam, hist = viterbi_acs.acs_decode_fused(
                cb, lam, hist, w[2], n_states=64, n_slots=4, k=7, rho=2,
                time_tile=TILE, pack_survivors=True, operands=ops[2])
            out.append(bits)
        return torch.cat(out), lam, hist

    def int8_case(rho):
        x, h = int8_in[rho]
        R = 1 << rho
        want = lambda: viterbi_acs.acs_decode_fused(  # noqa: E731
            x, lam0, h, w[rho], n_states=64, n_slots=R, k=7, rho=rho, time_tile=TILE,
            operands=ops[rho])
        geo = viterbi_acs.k2_launch_geometry(64, R, 2 * rho, ops[rho].cols.shape[1],
                                             DEPTH, TILE, False, F_64K)
        print(f"K2 int8 ring rho={rho}: the wrapper takes {geo}", flush=True)
        lib = libs["as is"]["acs_decode_fused"]
        return want, {
            "1 frame a block, rings in shared memory":
                lambda: k2(lib, x, lam0, h, ops[rho], rho, False, 1, True),
            "4 frames a block, rings in device memory":
                lambda: k2(lib, x, lam0, h, ops[rho], rho, False, 4, False),
        }

    kw = dict(n_states=64, n_slots=4, operands=ops[2])
    cases = {
        "K1 decode_64k": (
            lambda: viterbi_acs.acs_forward(blocks, lam0, w[2], **kw),
            {"as is": lambda: k1(libs["as is"]["acs_forward"], blocks, lam0, ops[2]),
             "shuffle max": lambda: k1(libs["shuffle max"]["acs_forward"], blocks, lam0,
                                       ops[2]),
             "renorm off": lambda: k1(libs["as is"]["acs_forward"], blocks, lam0, ops[2],
                                      renorm=False)}),
        "K1 recovery": (
            lambda: viterbi_acs.acs_forward(rec, entry, w[2], **kw),
            {"as is": lambda: k1(libs["as is"]["acs_forward"], rec, entry, ops[2]),
             "shuffle max": lambda: k1(libs["shuffle max"]["acs_forward"], rec, entry,
                                       ops[2])}),
        "K2 stream (16 launches)": (
            wrapper_stream,
            {"as is": lambda: stream(libs["as is"]["acs_decode_fused"], 4, True),
             "shuffle max": lambda: stream(libs["shuffle max"]["acs_decode_fused"], 4, True),
             "rings in device memory": lambda: stream(libs["as is"]["acs_decode_fused"], 4,
                                                      False)}),
    }
    for rho in (2, 3):
        cases[f"K2 int8 ring of {DEPTH} steps, rho={rho}, one launch"] = int8_case(rho)
    soft = torch.randn((T_64K, F_64K, 4), generator=gen, device=dev) * 1.5
    lam_s = torch.zeros((F_64K, 64), device=dev)
    lib = {name: libs[name]["acs_forward"]
           for name in ("as is", "one state a lane", "chain sum")}
    for frames in (F_SOFT, F_64K):
        x = soft[:, :frames].contiguous()
        l0 = lam_s[:frames]
        cases[f"K1-LOGPROB {frames} frames x {T_64K} steps"] = (
            lambda x=x, l0=l0: viterbi_acs.acs_forward(x, l0, w[2], semiring="logprob",
                                                       **kw),
            {"as is": lambda x=x, l0=l0: k1(lib["as is"], x, l0, ops[2], logprob=True),
             "one state a lane": lambda x=x, l0=l0: k1(lib["one state a lane"], x, l0,
                                                       ops[2], logprob=True, one_state=True),
             "chain sum": lambda x=x, l0=l0: k1(lib["chain sum"], x, l0, ops[2],
                                                logprob=True)})

    for case, (want, variants) in cases.items():
        ref = want()
        for name, fn in variants.items():
            out = fn()
            if name == "chain sum":  # another rounding of the same sum
                err = (out[0] - ref[0]).abs().max().item()
                print(f"{case}: chain sum's metrics within {err!r} of the wrapper's; "
                      f"{int((out[1] != ref[1]).sum())} survivors differ", flush=True)
                if not err <= 1e-3:
                    sys.exit(f"k12_variants: chain sum is {err} from the wrapper in {case}")
            elif name != "renorm off" and not all(
                    torch.equal(a, b) for a, b in zip(out, ref)):
                sys.exit(f"k12_variants: {name} changes the output of {case}")
            del out
        del ref
        times = {name: [] for name in variants}
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                times[name].append(cuda_ms(variants[name]))
        print(f"{case}: " + "; ".join(
            f"{name} {', '.join(f'{t:.3f}' for t in ts)} ms" for name, ts in times.items())
            + "; outputs bit-identical to the wrapper's (renorm off and chain sum "
            "excepted)", flush=True)


if __name__ == "__main__":
    main()
