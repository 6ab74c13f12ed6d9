"""K3's design choices measured side by side on one CUDA card:

    python3 tools/k3_variants.py

Builds ``csrc/transfer_matrix.cu`` three ways, each as the wrapper builds
it (``K3_PARTS`` translation units, then one link), into
``build/k3_variants/``:

  * ``as is``: this checkout's source;
  * ``tropical at four blocks``: the tropical instantiations at
    ``__launch_bounds__(128, 4)`` (at most 128 registers) where the source
    asks for three blocks an SM;
  * ``slot-order sum``: K3-LOGPROB's ``reduce_slots`` summing all R
    ``expf`` in slot order from 0 and taking the library ``logf``, as the
    plain version's ``Semiring.sum`` does, where the source sums 1 and
    the R - 1 others;
  * ``library logf``: ``reduce_slots`` taking the library ``logf`` of the
    sum where the source takes ``log_of_sum``, which must give its bits.

Prints each variant's registers and spills at S = 64, R = 4, the count of
special-function (MUFU) instructions in its LOGPROB kernel there, and
its K3 and K3-LOGPROB times (mean of 3 launches after a warm-up, CUDA
events) at ``chip_smoke.py``'s main shapes, in turns (each variant
twice, the order reversed the second time); each variant's tropical
output is held bit for bit to the plain version's, its LOGPROB output to
the plain version's within 1e-3, and whether its LOGPROB output at the
soft shape has the bits of ``as is`` is printed (``library logf`` must).
Needs one card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import CODE_K7_CCSDS, build_acs_tables  # noqa: E402
from repro_torch.core.kernel_geometry import (  # noqa: E402
    gather_tables, k3_block_frames, k3_smem_bytes,
)
from repro_torch.kernels import viterbi_acs  # noqa: E402
from repro_torch.kernels.ref import transfer_matrix_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BOUNDS = "SEMI == kLogprob ? 4 : 3"
TOURNAMENT = re.compile(
    r"(__device__ __forceinline__ float reduce_slots\(const float \(&pot\)\[R\]\) \{\n"
    r"  if constexpr \(SEMI == kLogprob\) \{\n).*?(\n    return top\[0\] \+ log_of_sum\(sum\);\n)",
    re.S)
SLOT_ORDER = r"""\1    float best = pot[0];
#pragma unroll
    for (int r = 1; r < R; ++r) best = fmaxf(best, pot[r]);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) sum += expf(pot[r] - best);
    return best + logf(sum);
"""
SHAPES = {"tropical": (262144, 16, 512), "logprob": (32768, 64, 256)}  # T, F, TT


def variant_sources():
    src = (CSRC / "transfer_matrix.cu").read_text()
    hdr = (CSRC / "acs_step.cuh").read_text()
    assert BOUNDS in src and TOURNAMENT.search(hdr)
    return {
        "as is": (src, hdr),
        "tropical at four blocks": (src.replace(BOUNDS, "SEMI == kLogprob ? 4 : 4"), hdr),
        "slot-order sum": (src, TOURNAMENT.sub(SLOT_ORDER, hdr, count=1)),
        "library logf": (src, hdr.replace("return top[0] + log_of_sum(sum);",
                                          "return top[0] + logf(sum);")),
    }


def build(item):
    """One variant's library, built as viterbi_acs.build builds K3."""
    name, (src, hdr) = item
    d = ROOT / "build" / "k3_variants" / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "transfer_matrix.cu").write_text(src)
    (d / "acs_step.cuh").write_text(hdr)
    nvcc = viterbi_acs._find_nvcc()
    flags = [f for f in viterbi_acs._NVCC_FLAGS if f != "-shared"]
    objs = [d / f"part{p}.o" for p in range(viterbi_acs.K3_PARTS)]
    procs = [subprocess.Popen([nvcc, *flags, f"-DK3_PART={p}", "-c", "-o", str(o),
                               str(d / "transfer_matrix.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p, o in enumerate(objs)]
    log = ""
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        log += out + err
    lib = d / "k3.so"
    subprocess.run([nvcc, *viterbi_acs._NVCC_FLAGS, "-o", str(lib), *map(str, objs)],
                   check=True, capture_output=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(objs[2])],
                          capture_output=True, text=True).stdout
    body = re.search(r"Function : \S*transfer_matrix_kernelILi64ELi4ELi1E\S*\n"
                     r"(.*?)(?=\n\s*Function :|\Z)", sass, re.S)
    regs = [line for line in chip_smoke.ptxas_report(log)
            if "_kernel<64, 4," in line]
    return name, lib, regs, len(re.findall(r"\bMUFU\.", body.group(1) if body else ""))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k3_variants: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(build, variant_sources().items()))
    dev = torch.device("cuda")
    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w, device=dev)
    theta, _ = gather_tables(w, 4, 64, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    blocks = {
        "tropical": torch.randint(-16, 17, (262144, 16, 4), generator=gen, device=dev).float(),
        "logprob": torch.randn((32768, 64, 4), generator=gen, device=dev) * 1.5,
    }
    libs = {}
    for name, lib_path, regs, mufu in built:
        lib = ctypes.CDLL(str(lib_path))
        lib.transfer_matrix_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
        print(f"{name}: {'; '.join(regs)}; {mufu} MUFU instructions in "
              "transfer_matrix_kernel<64, 4, 1>", flush=True)

    def run(name, semiring, x, TT):
        T, F, B = x.shape
        m = torch.empty((T // TT, F, 64, 64), device=dev)
        err = libs[name].transfer_matrix_launch(
            x.data_ptr(), theta.data_ptr(), m.data_ptr(), T, F, B, 64, 4, TT,
            k3_block_frames(64), 0, 0, 0, int(semiring == "logprob"),
            k3_smem_bytes(64, 4), torch.cuda.current_device(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return m

    first = {}
    for semiring, (T, F, TT) in SHAPES.items():
        x = blocks[semiring]
        small = x[:1536, :13].contiguous()
        want = transfer_matrix_ref(small, w, n_states=64, n_slots=4, transfer_tile=96,
                                   semiring=semiring)
        for name in libs:
            got = run(name, semiring, small, 96)
            torch.cuda.synchronize()
            if semiring == "tropical":
                first.setdefault(semiring, got)
                ok = torch.equal(got, first[semiring]) and torch.equal(got, want)
                print(f"{name}, tropical: {'bit-identical' if ok else 'DIFFERENT'}")
            else:
                err = (got - want).abs().max().item()
                ok = err <= 1e-3
                print(f"{name}, logprob: max |diff| from the plain version {err!r}")
            if not ok:
                sys.exit(f"k3_variants: {name} is wrong at {semiring}")
    soft = {name: run(name, "logprob", blocks["logprob"], SHAPES["logprob"][2])
            for name in libs}
    for name, m in soft.items():
        same = torch.equal(m, soft["as is"])
        print(f"{name}, logprob at the soft shape: "
              f"{'the bits' if same else 'not the bits'} of as is")
        if name == "library logf" and not same:
            sys.exit("k3_variants: log_of_sum does not give logf's bits")
    del soft
    for turn, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            for semiring, (T, F, TT) in SHAPES.items():
                ms = chip_smoke.cuda_ms(lambda: run(name, semiring, blocks[semiring], TT),
                                        reps=3)
                print(f"turn {turn} {name}: K3 {semiring} {ms:.3f} ms at F={F} "
                      f"T={T} TT={TT}", flush=True)


if __name__ == "__main__":
    main()
