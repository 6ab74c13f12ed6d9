"""K1 and K2 of this checkout against those of another checkout (an
unpacked ``git archive`` of an earlier commit) on the same inputs, on one
CUDA card, in turns: other, this, this, other.

    python3 tools/k12_vs_parent.py OTHER_CHECKOUT

Each turn is a process of its own that imports the ``repro_torch`` of
its checkout and calls its ``kernels.viterbi_acs`` wrappers at the
shapes of ``chip_smoke.py``'s main paths (with W's gather operands made
once, as the decoder makes them, where the wrappers take them), inputs
made on the card from one seed:
  * K1 at decode_64k: 512 frames x 32,768 radix steps of ccsds-k7, rho=2,
    integer LLRs, int8 survivors (``decode_batch``'s launch);
  * K2 over the stream: the same LLRs as 16 launches of 2,048 steps, the
    metrics and the packed ring of 2,560 steps carried from launch to
    launch, tile 32 (``decode_stream_chunked``'s launches);
  * the recovery K1: 8,192 frames x 512 steps from integer entry metrics
    (the time-parallel decode's launch at decode_512k_f16);
  * K1-LOGPROB: 64 frames x 32,768 steps of half-scaled Gaussian LLRs
    (``forward_fused(semiring=LOGPROB)``'s launch at the soft cell's
    shape).
Prints each turn's mean time over 3 calls after a warm-up (CUDA events)
and whether each output of this checkout is bit-identical to the other's
(SHA-256 of every output tensor's bytes).  Where a checkout sums
K1-LOGPROB's logsumexp in another order than the other (the dense step
before the gathered one), its outputs are held to the other's within
1e-3 on the metrics instead, and the survivors that differ are counted.
Needs one card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

F_64K, T_64K = 512, 32768  # decode_64k: 512 frames x 65,536 stages
CHUNK_STEPS, DEPTH, TILE = 2048, 2560, 32  # the stream: 16 chunks of 4096 stages
F_REC, T_REC = 8192, 512  # the recovery: 16 frames x 512 tiles of 512 steps
F_SOFT = 64
CASES = ("K1 decode_64k", "K2 stream (16 launches)", "K1 recovery", "K1-LOGPROB")
LOGPROB_ATOL = 1e-3  # K1-LOGPROB's metrics between checkouts that sum in other orders


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


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


def worker(root: str, out_path: str) -> None:
    """One turn: this process runs ``root``'s K1 and K2 and writes their
    times and output digests to ``out_path``."""
    sys.path.insert(0, str(Path(root) / "src"))
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import viterbi_acs

    dev = torch.device("cuda")
    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kw = dict(n_states=64, n_slots=4)
    k1, k2 = viterbi_acs.acs_forward, viterbi_acs.acs_decode_fused
    trop = dict(kw)  # the tropical launches: W's operands made once, where taken
    if "operands" in inspect.signature(k1).parameters:
        trop["operands"] = viterbi_acs.gather_operands(w, 4, 64, 4)
    res = {}

    blocks = torch.randint(-16, 17, (T_64K, F_64K, 4), generator=gen, device=dev).float()
    lam0 = torch.full((F_64K, 64), -1e9, device=dev)
    lam0[:, 0] = 0.0
    ms = cuda_ms(lambda: k1(blocks, lam0, w, **trop))
    res[CASES[0]] = (ms, digest(*k1(blocks, lam0, w, **trop)))

    chunks = [blocks[lo:lo + CHUNK_STEPS].contiguous()
              for lo in range(0, T_64K, CHUNK_STEPS)]
    hist0 = torch.zeros((DEPTH, F_64K, 4), dtype=torch.int32, device=dev)

    def stream():
        lam, hist, out = lam0, hist0, []
        for cb in chunks:
            bits, lam, hist = k2(cb, lam, hist, w, k=7, rho=2, time_tile=TILE,
                                 pack_survivors=True, **trop)
            out.append(bits)
        return out, lam, hist

    ms = cuda_ms(stream)
    bits, lam, hist = stream()
    res[CASES[1]] = (ms, digest(*bits, lam, hist))
    del chunks, bits, blocks

    rec = torch.randint(-16, 17, (T_REC, F_REC, 4), generator=gen, device=dev).float()
    entry = torch.randint(-64, 1, (F_REC, 64), generator=gen, device=dev).float()
    ms = cuda_ms(lambda: k1(rec, entry, w, **trop))
    res[CASES[2]] = (ms, digest(*k1(rec, entry, w, **trop)))
    del rec

    soft = torch.randn((T_64K, F_SOFT, 4), generator=gen, device=dev) * 1.5
    lam_s = torch.zeros((F_SOFT, 64), device=dev)
    ms = cuda_ms(lambda: k1(soft, lam_s, w, semiring="logprob", **trop))
    out = k1(soft, lam_s, w, semiring="logprob", **trop)
    res[CASES[3]] = (ms, digest(*out))
    torch.save([t.cpu() for t in out], out_path + ".pt")
    Path(out_path).write_text(json.dumps(res))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k12_vs_parent: needs a CUDA card")
    other = Path(sys.argv[1]).resolve()
    this = Path(__file__).resolve().parents[1]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    turns = []
    (this / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=this / "build") as tmp:
        for turn, root in enumerate((other, this, this, other)):
            out = Path(tmp) / f"{turn}.json"
            subprocess.run([sys.executable, __file__, "--worker", str(root), str(out)],
                           check=True)
            turns.append(json.loads(out.read_text()))
            turns[-1]["logprob"] = torch.load(str(out) + ".pt")
            print(f"turn {turn} ({'this' if root == this else 'other'} checkout): "
                  + "; ".join(f"{c} {turns[-1][c][0]:.3f} ms" for c in CASES), flush=True)
    for c in CASES:
        this_ms = [turns[1][c][0], turns[2][c][0]]
        other_ms = [turns[0][c][0], turns[3][c][0]]
        same = len({t[c][1] for t in turns}) == 1
        note = ""
        if c == "K1-LOGPROB" and not same:
            # each checkout must repeat its own bits; across them, a rounding
            if turns[0][c][1] != turns[3][c][1] or turns[1][c][1] != turns[2][c][1]:
                sys.exit("k12_vs_parent: K1-LOGPROB is not deterministic")
            (lam_t, phi_t), (lam_o, phi_o) = turns[1]["logprob"], turns[0]["logprob"]
            err = (lam_t - lam_o).abs().max().item()
            note = (f" (metrics within {err!r} of the other's, limit {LOGPROB_ATOL}; "
                    f"{int((phi_t != phi_o).sum())} of {phi_t.numel()} survivors differ)")
            same = err <= LOGPROB_ATOL
        print(f"{c}: this {this_ms[0]:.3f}, {this_ms[1]:.3f} ms; other "
              f"{other_ms[0]:.3f}, {other_ms[1]:.3f} ms; this/other "
              f"{sum(this_ms) / sum(other_ms):.4f}; outputs "
              f"{'bit-identical' if not note and same else 'DIFFERENT'}{note}",
              flush=True)
        if not same:
            sys.exit(f"k12_vs_parent: {c} differs between the checkouts")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
