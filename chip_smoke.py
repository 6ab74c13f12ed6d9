"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``; imports nothing of JAX or of the JAX package.  Phases, each of
which ends the run with a non-zero exit when it fails:

  1. probe   — a CUDA device is present; print its name and power limit;
  2. build   — compile every kernel of the main path from the checkout's
               sources (nvcc, into build/torch_ext/);
  3. kernel  — K1 (``acs_forward``) against its plain PyTorch version at
               F=512 frames x T=1024 radix steps on quantised integer
               LLRs, over f32/bf16 matmul x packed/int8 survivors x renorm
               on/off: final metrics, survivors and traced-back bits must
               be bit-identical;
  4. decode  — the paper's workload (cell decode_64k): ccsds-k7,
               rho=2, 512 zero-terminated frames x 65536 stages through
               ``ViterbiDecoder.from_standard("ccsds-k7").decode_batch``
               at f32 precision.  AWGN at Eb/N0 = 4 dB must decode to
               BER <= 1e-4 with K1 launched on that run; quantised
               integer LLRs must decode the first 8 frames bit for bit as
               the plain path (``use_kernel=False``) does; a small input
               must match the scalar oracle.  Times (CUDA events, after a
               warm-up): K1, the traceback, decode_batch wall time and
               decoded Mb/s, K1's plain version and a torch.matmul
               yardstick at the same shape.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

F_FULL, N_FULL = 512, 65536  # cell decode_64k: 512 streams x 65536 stages
F_SWEEP, T_SWEEP = 512, 1024
EBN0_DB, BER_LIMIT = 4.0, 1e-4
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet) at the 700 W limit
PEAK_F32_FLOPS = 67e12  # non-tensor float32
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 1, warmup=None) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, measured with
    CUDA events after one warm-up call (``warmup`` or ``fn`` itself)."""
    (warmup or fn)()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn):
    """(result, host-clock ms) of ``fn``, bracketed by synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def library_forward(blocks, lam0, w, n_states, n_slots):
    """Yardstick only: the K1 step as stock PyTorch calls (torch.matmul,
    then torch.max for the slot max and argmax), one step at a time."""
    T, F, _ = blocks.shape
    phi = torch.empty((T, F, n_states), dtype=torch.int8, device=blocks.device)
    lam = lam0
    for t in range(T):
        pot = torch.matmul(torch.cat([blocks[t], lam], dim=1), w)
        new, idx = pot.view(F, n_states, n_slots).max(dim=-1)
        phi[t] = idx
        lam = new - new.amax(dim=-1, keepdim=True)
    return lam, phi


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not beside this script ({exc})")
    from repro_torch.core import (
        CODE_K7_CCSDS,
        ViterbiDecoder,
        build_acs_tables,
        conv_encode_torch,
        viterbi_decode_ref,
    )
    from repro_torch.core.channel import awgn, bpsk, llr
    from repro_torch.core.viterbi import (
        AcsPrecision,
        blocks_from_llrs,
        forward_fused,
        init_metric,
        traceback,
    )
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import acs_forward_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. probe ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = viterbi_acs.build()
    print(f"build: K1 {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    spec = CODE_K7_CCSDS
    tables = build_acs_tables(spec, 2)
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    w = torch.as_tensor(tables.fused_w, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    max_abs_err = 0.0

    # -- 3. kernel vs plain version ---------------------------------------
    blocks = torch.randint(
        -8, 9, (T_SWEEP, F_SWEEP, B), generator=gen, device=dev
    ).float()
    lam0 = init_metric(F_SWEEP, S, 0, device=dev)
    for mm in (torch.float32, torch.bfloat16):
        for pack in (False, True):
            for renorm in (True, False):
                kw = dict(n_states=S, n_slots=R, matmul_dtype=mm,
                          renorm=renorm, pack_survivors=pack)
                lam_k, phi_k = viterbi_acs.acs_forward(blocks, lam0, w, **kw)
                lam_p, phi_p = acs_forward_ref(blocks, lam0, w, **kw)
                fs = lam_p.argmax(dim=-1)
                bits_k = traceback(phi_k, fs, tables)
                bits_p = traceback(phi_p, fs, tables)
                torch.cuda.synchronize()
                err = (lam_k - lam_p).abs().max().item()
                max_abs_err = max(max_abs_err, err)
                same = (torch.equal(lam_k, lam_p) and torch.equal(phi_k, phi_p)
                        and torch.equal(bits_k, bits_p))
                label = f"mm={str(mm)[6:]} packed={pack} renorm={renorm}"
                print(f"kernel vs plain {label}: "
                      f"{'bit-identical' if same else 'DIFFERENT'}")
                if not same:
                    fail(f"K1 differs from its plain version ({label}), "
                         f"max |lam| diff {err}")

    # -- 4. the main path at full width -----------------------------------
    n_info = N_FULL - (spec.k - 1)
    info = torch.randint(0, 2, (F_FULL, n_info), generator=gen, device=dev)
    msg = torch.cat(
        [info, torch.zeros(F_FULL, spec.k - 1, dtype=info.dtype, device=dev)],
        dim=1,
    )  # tail_flush: every frame ends in state 0
    symbols = bpsk(conv_encode_torch(msg, spec))
    llrs = llr(awgn(gen, symbols, EBN0_DB, spec.rate), EBN0_DB, spec.rate)
    print(f"decode_64k input: llrs {tuple(llrs.shape)} "
          f"{llrs.numel() * 4 / 2**20:.0f} MiB", flush=True)

    decoder = ViterbiDecoder.from_standard(
        "ccsds-k7", precision=AcsPrecision()
    )
    viterbi_acs.acs_forward.launches = 0
    bits = decoder.decode_batch(llrs)
    torch.cuda.synchronize()
    launches = viterbi_acs.acs_forward.launches
    if launches < 1:
        fail("decode_batch did not launch K1")
    if bits.shape != (F_FULL, N_FULL) or bits.device.type != "cuda":
        fail(f"decode_batch returned {tuple(bits.shape)} on {bits.device}")
    errors = int((bits[:, :n_info] != info).sum())
    ber = errors / (F_FULL * n_info)
    print(f"AWGN Eb/N0={EBN0_DB} dB: {errors} bit errors in "
          f"{F_FULL * n_info} bits, BER {ber:.3e} (limit {BER_LIMIT:g}); "
          f"K1 launches {launches}")
    if not ber <= BER_LIMIT:
        fail(f"BER {ber:.3e} above {BER_LIMIT:g}")

    quant = torch.clamp(torch.round(llrs), -16, 16)  # quantised integer LLRs
    bits_q = decoder.decode_batch(quant)
    plain = ViterbiDecoder.from_standard("ccsds-k7", use_kernel=False)
    bits_plain = plain.decode_batch(quant[:8])
    torch.cuda.synchronize()
    if not torch.equal(bits_q[:8], bits_plain):
        fail("integer LLRs: K1 path and plain path decode frames 0-7 differently")
    print("integer LLRs: frames 0-7 bit-identical to the plain path")

    small = quant[:2, :256].cpu().numpy()
    oracle = np.stack([viterbi_decode_ref(f, spec) for f in small])
    if not np.array_equal(decoder.decode_batch(small).cpu().numpy(), oracle):
        fail("decode_batch disagrees with the scalar oracle on 2 x 256 stages")
    print("small input: decode_batch == scalar oracle (2 frames x 256 stages)")

    # timings at the decode_64k shape (integer LLRs, so the plain version
    # and the kernel can also be held to bit-identity at full width)
    blocks = blocks_from_llrs(quant, 2).contiguous()
    lam0 = init_metric(F_FULL, S, 0, device=dev)
    kw = dict(n_states=S, n_slots=R)
    k1_ms = cuda_ms(lambda: viterbi_acs.acs_forward(blocks, lam0, w, **kw), reps=5)
    lam_k, phi_k = viterbi_acs.acs_forward(blocks, lam0, w, **kw)
    fs = torch.zeros(F_FULL, dtype=torch.int64, device=dev)
    tb_ms = cuda_ms(
        lambda: traceback(phi_k, fs, tables),
        warmup=lambda: traceback(phi_k[:64], fs, tables),
    )
    out = {}
    plain_ms = cuda_ms(
        lambda: out.update(p=acs_forward_ref(blocks, lam0, w, **kw)),
        warmup=lambda: acs_forward_ref(blocks[:16], lam0, w, **kw),
    )
    lam_p, phi_p = out.pop("p")
    full_err = (lam_k - lam_p).abs().max().item()
    max_abs_err = max(max_abs_err, full_err)
    if not (torch.equal(lam_k, lam_p) and torch.equal(phi_k, phi_p)):
        fail(f"K1 differs from its plain version at full width ({full_err})")
    del phi_p
    lib_ms = cuda_ms(
        lambda: library_forward(blocks, lam0, w, S, R),
        warmup=lambda: library_forward(blocks[:16], lam0, w, S, R),
    )
    walls = sorted(host_ms(lambda: decoder.decode_batch(llrs))[1] for _ in range(3))
    wall_ms = walls[1]
    mbps = F_FULL * N_FULL / wall_ms / 1e3
    # the same call in its stages, each ending in a synchronize
    _, validate_ms = host_ms(lambda: decoder._harden(llrs))
    (lam_d, phi_d), forward_ms = host_ms(lambda: forward_fused(
        blocks_from_llrs(llrs, 2), init_metric(F_FULL, S, 0, device=dev), tables
    ))
    _, tb_host_ms = host_ms(lambda: traceback(phi_d, lam_d.argmax(dim=-1), tables))
    del phi_d
    print(f"time K1 acs_forward: {k1_ms:.3f} ms")
    print(f"time traceback: {tb_ms:.3f} ms")
    print(f"time decode_batch wall: {wall_ms:.3f} ms (median of "
          f"{', '.join(f'{x:.3f}' for x in walls)}; K1 {k1_ms / wall_ms:.1%}, "
          f"traceback {tb_ms / wall_ms:.1%})")
    print(f"decode_batch stages (host clock): validate {validate_ms:.3f} ms, "
          f"forward_fused {forward_ms:.3f} ms, traceback {tb_host_ms:.3f} ms")
    print(f"decoded: {mbps:.3f} Mb/s")
    print(f"time K1 plain version (acs_forward_ref): {plain_ms:.3f} ms")
    print(f"time torch.matmul yardstick: {lib_ms:.3f} ms")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    T = N_FULL // 2
    flops = 2 * F_FULL * (B + S) * S * R * T
    bytes_moved = (blocks.numel() * 4 + lam0.numel() * 4 + w.numel() * 4
                   + phi_k.numel() * phi_k.element_size() + lam_k.numel() * 4)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    print(json.dumps({"kernels": [{
        "name": "K1 acs_forward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acs_forward.cu",
        "replaces": "src/repro/kernels/viterbi_acs.py:172",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
