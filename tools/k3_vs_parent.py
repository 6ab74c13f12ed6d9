"""K3 and K3-LOGPROB of this checkout against those of another checkout
(an unpacked ``git archive`` of an earlier commit) on the same inputs,
on one CUDA card, in turns: other, this, this, other.

    python3 tools/k3_vs_parent.py OTHER_CHECKOUT

Each turn is a process of its own that imports the ``repro_torch`` of
its checkout and calls its ``kernels.viterbi_acs.transfer_matrix`` at
the shapes of ``chip_smoke.py``'s main paths: the time-parallel
decode's (16 frames x 262,144 radix steps, TT = 512, integer LLRs,
tropical) and ``decode_soft``'s (64 x 32,768, TT = 256, half-scaled
Gaussian LLRs, LOGPROB), inputs made on the card from one seed.  Prints
each turn's mean time over 3 launches after a warm-up (CUDA events),
whether the tropical outputs are bit-identical and how far apart the
LOGPROB ones are.  Needs one card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SHAPES = {  # semiring: (T, F, TT)
    "tropical": (262144, 16, 512),
    "logprob": (32768, 64, 256),
}


def inputs(semiring):
    T, F, TT = SHAPES[semiring]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if semiring == "tropical":
        return torch.randint(-16, 17, (T, F, 4), generator=gen, device="cuda").float()
    return torch.randn((T, F, 4), generator=gen, device="cuda") * 1.5


def worker(root: str, out_dir: str) -> None:
    """One turn: this process runs ``root``'s K3 and writes its outputs
    and times into ``out_dir``."""
    sys.path.insert(0, str(Path(root) / "src"))
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import viterbi_acs

    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w, device="cuda")
    times = {}
    for semiring, (T, F, TT) in SHAPES.items():
        blocks = inputs(semiring)
        kw = dict(n_states=64, n_slots=4, transfer_tile=TT, semiring=semiring)
        m = viterbi_acs.transfer_matrix(blocks, w, **kw)  # warm-up, and the output
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            viterbi_acs.transfer_matrix(blocks, w, **kw)
        stop.record()
        stop.synchronize()
        times[semiring] = start.elapsed_time(stop) / 3
        torch.save(m.cpu(), Path(out_dir) / f"{semiring}.pt")
    (Path(out_dir) / "times.json").write_text(json.dumps(times))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k3_vs_parent: needs a CUDA card")
    other = Path(sys.argv[1]).resolve()
    this = Path(__file__).resolve().parents[1]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    runs = []
    (this / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=this / "build") as tmp:
        for turn, root in enumerate((other, this, this, other)):
            out = Path(tmp) / str(turn)
            out.mkdir()
            subprocess.run([sys.executable, __file__, "--worker", str(root), str(out)],
                           check=True)
            times = json.loads((out / "times.json").read_text())
            runs.append(out)
            print(f"turn {turn} ({'this' if root == this else 'other'} checkout): "
                  + ", ".join(f"K3 {s} {t:.3f} ms" for s, t in times.items()), flush=True)
        for semiring in SHAPES:
            a = torch.load(runs[0] / f"{semiring}.pt")
            b = torch.load(runs[1] / f"{semiring}.pt")
            reach = (a > -1e8) & (b > -1e8)
            print(f"{semiring} at T, F, TT = {SHAPES[semiring]}: "
                  f"{'bit-identical' if torch.equal(a, b) else 'not bit-identical'}; "
                  f"max |this - other| {(a - b)[reach].abs().max().item()!r} over "
                  f"{int(reach.sum())} reachable entries, {int((a != b).sum())} of "
                  f"{a.numel()} entries differ", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
