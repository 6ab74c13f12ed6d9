"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``; imports nothing of JAX or of the JAX package.  Phases, each of
which ends the run with a non-zero exit when it fails:

  1. probe   — a CUDA device is present; print its name and power limit;
  2. build   — compile every kernel from the checkout's sources (one nvcc
               per source, side by side, into build/torch_ext/);
  3. kernel  — K1 (``acs_forward``) against its plain PyTorch version at
               F=512 frames x T=1024 radix steps on quantised integer
               LLRs, over f32/bf16 matmul x packed/int8 survivors x renorm
               on/off: final metrics, survivors and traced-back bits must
               be bit-identical; then the shape sweep: K1 and K2 bit for
               bit against their plain versions at every shape the
               gathered kernels specialise on (ccsds-k7, gsm-cs1 with two
               16-state frames a warp, lte-tbcc at rate 1/3, a k=6 code of
               one 32-state frame a warp, a k=8 code whose frame spans two
               warps and a k=10 one of eight; rho =
               1..4, packed rings where 16 slots fit a word; F=37, ragged
               against every block; K2 also at T=TT and TT=1) on integer
               LLRs in -2..2 from all-equal start metrics (ties
               everywhere) and on AWGN LLRs (against the plain version on
               the CPU, which sums in k order as the kernels do);
               K1-LOGPROB at every (code, rho) of the sweep against its
               plain version within ``logprob_bound`` (integer LLRs with
               and without renorm, packed where 16 slots fit a word, and
               AWGN LLRs), its survivors differing only at potential gaps
               within PHI_TIE; and a W whose metric half is not the
               one-hot must raise ValueError in K1, K1-LOGPROB and K2
               before any launch;
  4. decode  — the paper's workload (cell decode_64k): ccsds-k7,
               rho=2, 512 zero-terminated frames x 65536 stages through
               ``ViterbiDecoder.from_standard("ccsds-k7").decode_batch``
               at f32 precision.  AWGN at Eb/N0 = 4 dB must decode to
               BER <= 1e-4 with K1 launched on that run; quantised
               integer LLRs must decode the first 8 frames bit for bit as
               the plain sequential path (``use_kernel=False``,
               ``time_parallel=False``) does; a small input
               must match the scalar oracle.  Times (CUDA events, after a
               warm-up): K1, the traceback, decode_batch wall time and
               decoded Mb/s, K1's plain version and a torch.matmul
               yardstick at the same shape;
  5. k2      — K2 (``acs_decode_fused``) against its plain version at
               F=512 x T=1024 radix steps, depth D=256 steps, tile 32, on
               quantised integer LLRs with a random entry ring, over
               f32/bf16 matmul x packed/int8 ring x renorm on/off, plus a
               frame count that is not a multiple of K2's block, a ring
               too large for shared memory, and the streaming path's own
               geometry (F=512, its depth of 2560 steps and tile, packed:
               4 frames a block, 128 blocks, which must be one wave):
               bits, metrics and exit ring must be bit-identical; each
               case prints K2's grid, frames a block, shared bytes and
               blocks an SM;
  6. stream  — the same 512 x 65536 input through
               ``decode_stream_chunked(chunk_len=4096, initial_state=0)``
               (f32, depth 5120 stages, packed ring): one K2 launch per
               chunk (16), BER <= 1e-4, and bits equal to decode_batch's,
               on the AWGN and on the integer LLRs.  Times: K2 over the
               stream (CUDA events), the flush traceback, the wall time
               and decoded Mb/s, and the two-pass chunked path
               (``one_pass=False``: K1 and the plain traceback) once as the
               yardstick at this shape;
  7. tiled   — one stream of 2^20 stages through ``decode_stream_tiled``
               (64-stage windows with 32 stages of overlap: 16384 windows
               of 64 steps, tile 16) in one K2 launch; K2 bit-identical to
               its plain version at that shape; BER beside the two-pass
               tiled path's;
  8. multi   — ``decode_chunk_multi``: two sessions at different stream
               positions emit on the card what each emits alone, and
               reach the same metrics, ring and position;
  9. timepar — K3 (``transfer_matrix``) against its plain version, bit
               for bit on quantised integer LLRs, at F=16 x T=4096 radix
               steps, tile 64, over f32/bf16 matmul x split_dot on/off x
               f32/bf16 carry, at a frame count that is not a multiple of
               K3's block, and at the latency shape below; then the
               latency shape itself (cell decode_512k_f16): ccsds-k7,
               rho=2, 16 zero-terminated frames x 2^19 stages through
               ``decode_batch(time_parallel=True)``: dispatch label
               ``time_parallel``, one K3 and one K1 launch, BER <= 1e-4
               at 4 dB, the bits that differ from the sequential path
               printed, and the sequential path's bits on the integer
               LLRs.  Times: K3, the prefix and suffix scans, the
               recovery K1, the traceback, the wall time (median of 3)
               and decoded Mb/s, the sequential decode_batch once, K3's
               plain version; the budget sweep of
               ``backend.device_underfill_rows`` (decode_batch at 2^16
               stages, time_parallel False and True, F in {1, 4, 16, 64,
               256}, 3 samples each), with the bits in which the two paths
               differ at each F on the AWGN input and on its integer copy,
               and whether each difference is a path-metric tie; and which
               path ``decode_batch`` picks on auto at F=16 and at the
               decode_64k shape;
 10. soft    — the soft-output path at full width (S=64):
               ``decode_soft(output="llr")`` on 64 of phase 4's AWGN
               frames x 65536 stages (T'=32768, TT=256, N=128): dispatch
               ``soft``, one K3-LOGPROB launch, BER of ``llr < 0`` <= 1e-4,
               the bits that differ from decode_batch's printed; K3-LOGPROB
               against its plain version at that shape; K1-LOGPROB through
               ``forward_fused(semiring=LOGPROB)`` on the same blocks (one
               launch) against its plain version; both again at a depth
               short enough (tiles of 8 steps, 8 steps) for the bound to
               sit far under the tropical instantiation's distance, which
               each of these gates (and K3's at TT=256) must reject.
               Times: K3-LOGPROB, the
               two LOGPROB compose scans, the alpha and beta scans and
               ``_llrs_from_joints`` (CUDA events), the decode_soft wall
               (median of 3), Mb/s, peak memory, K1-LOGPROB, both plain
               versions and K1-LOGPROB's yardstick (``library_forward``'s
               LOGPROB form: torch.matmul, torch.logsumexp over the slots
               and torch.argmax a step).  Then
               ``decode_soft(output="list", n_list=4)`` at
               64 x 4096 stages (times of ``list_forward`` and
               ``list_traceback``; at n_list=1 the bits equal
               ``decode_batch(time_parallel=False)``'s exactly, on the AWGN
               and on the integer LLRs), and lte-tbcc, 512 tail-biting
               frames x 64 bits through ``bcjr_circular_llrs``: K3-LOGPROB
               at one step a tile (beta=3) against its plain version, BER,
               times;
 11. codes   — the standard codes on the reference's cells
               (``configs/viterbi_k7.py``), LLRs drawn on the card
               (``simulate.point_key`` seeds, ``sim_frame_batch``):
               decode_64k_wifi_r34 (512 frames x 65536 kept LLRs, 6 dB)
               through ``decode_batch`` (one K1) and
               ``decode_stream_chunked(chunk_len=4096, initial_state=0)``
               (the two-pass step, one K1 a chunk; each chunk's path,
               launches and CUDA-event times printed), chunked bits ==
               batch bits; ``decode_soft(output="llr")`` on 64 of its
               frames (one K3-LOGPROB); a 2^20-LLR wifi-11a-r34 stream
               through ``decode_stream_tiled`` (one K2) and
               ``decode_batch(time_parallel=True)`` (one K3, one K1),
               tiled bits == batch bits; decode_tbcc_blocks (lte-tbcc,
               8192 x 128 bits, 6 dB) through ``decode_batch`` and
               ``decode_tailbiting`` (WAVA, one K1 a circulation;
               converged share printed) and 64 of them with
               ``time_parallel=True, transfer_tile=8`` (one K3, one K1 a
               circulation; bits and flags == sequential WAVA);
               decode_64k_dvb_r78 (7 dB) through ``decode_batch``;
               ``codes.smoke`` and ``core.soft_smoke`` on the card.  BER
               <= 1e-4 on the punctured paths, <= TBCC_BER_LIMIT on
               lte-tbcc.  Every kernel call of these paths is kept from
               an integer-LLR run and held bit for bit to its plain
               version on the same tensors (K1 at both batch shapes, at
               chunks 1, 2 and the last, at each WAVA circulation and
               recovery; K2 on the tiled windows; K3 at the stream's tile
               and at TT=8); K3-LOGPROB from the soft run within
               ``logprob_bound``, with the tropical instantiation rejected
               at TT=8.  Times: CUDA events of K1, K2, K3, K3-LOGPROB and
               the tracebacks on each path, walls (median of 3 after the
               main run; chunked: the gated call itself, one sample) and
               decoded Mb/s of message bits; the phase's seconds against
               its budget of 75 s.
 12. serve   — the serving engine (``serve.make_decode_engine(device=
               "cuda")``, max_batch 64) on requests drawn on the card at
               5.5 dB: ccsds-k7 throughput traffic of 1000, 3000, 6000 and
               8192 stages (32 each, flushed and not), 12000 and 16384
               stages (stream route), latency traffic of 2000 and 4096
               stages (time-parallel route), wifi-11a-r34 of 3000 and 8192
               kept LLRs, 512 lte-tbcc blocks of 40 bits (WAVA), 16 soft
               requests of 4096 stages, and 8 session tenants x 4 chunks of
               4096 stages in a table of 6 (two evictions).  The clean run,
               on the host clock, is the main path: launch counts zeroed
               just before; each dispatch's launches must be its route's
               (K1 a batch cell, K1 a shard, K3 + K1, K2 a stream chunk or
               session group, K1 a WAVA circulation, K3-LOGPROB); no fault,
               retry or degradation; every ticket's bits equal a direct
               call of its route's entry point on the unpadded frames (one
               call a request group; soft LLRs within 1e-4), each tenant's
               output ``decode_stream_chunked`` on what it consumed.  The
               batch traffic again on ``frame_mesh()`` and on two logical
               shards (the sharded route, K1 once a shard); under a chaos
               schedule on four shards (3 device failures, 2 timeouts, a
               compile flake: 4 -> 2 -> 1 shard, then batch), with the
               sessions, bits equal to the clean run's; scrubbed at rate 1
               with one bit flip on two shards: exactly the flipped ticket
               ``sdc_detected`` and its device quarantined.  Then one
               recorder-enabled cell (``engine_dispatch_seconds`` beside
               K1's CUDA-event time) and an integer-LLR replay whose K1
               and K3 calls are held bit for bit to their plain versions,
               K2's on their first two tiles (its plain version walks the
               ring in Python), K3-LOGPROB within ``logprob_bound``.
               Prints routes, padding, walls, sojourns and the phase's
               seconds against a budget of 60 s; the kernels line gains
               each kernel's ``serve_launches`` per route.
 13. launcher — the serving launcher through the port's own entry
               points, in process: ``launch.serve.main`` with
               ``--service viterbi`` at CONFIG's serving shape (512
               streams x 65536 stages, 4 dB, one timed batch after the
               warm-up) in each mode: ``tiled --use-kernel`` (every
               stream's windows in one K2 launch), ``chunked
               --use-kernel`` (16 K2 and the flush), ``batch`` (one K1),
               ``sharded --use-kernel`` on ``frame_mesh()`` (one K2 a
               card); ``time_parallel`` at 16 x 2^19 (one K3, one K1);
               ``--optimized tiled --use-kernel``; wifi-11a-r34 tiled at
               6 dB; lte-tbcc at 6 dB, 8192 x 128 (forced batch: WAVA,
               one K1 a circulation).  Each call of the decode function
               must launch exactly its kernels; BER <= 1e-3 at 4 dB (the
               reference's expectation for the launcher), <= 1e-4 on
               wifi-11a-r34, <= TBCC_BER_LIMIT on lte-tbcc; the timed
               batch's bits equal a direct call of the entry point the
               mode names on the same card LLRs (``decode_stream_tiled``
               on the first, middle and last streams; the batch entry
               points on the whole batch); each mode's decode function
               on integer LLRs at 16 x 8192 (512 x 8192 batch, 16 x
               65536 time-parallel, 512 lte-tbcc blocks), on the main
               path's kernels, has every K1 and K3 call held bit for
               bit to its plain version and every K2 call on its first,
               middle and last tiles.  ``sharded_decode_time_parallel``
               on four logical shards at 16 x 2^19 (one K3 and one K1 a
               shard) on phase 9's AWGN codeword LLRs: bits == phase 9's
               sequential decode, BER, its kernel calls held on integer
               LLRs.  ``--service engine --slo mixed`` (128 requests of
               ccsds-k7, wifi-11a-r34 and lte-tbcc) with
               ``--metrics-jsonl``, each dispatch's launches held to its
               route, no fault or error, then ``obs.top --jsonl`` on the
               log; again with ``--chaos`` (a device failure, a timeout, a
               compile error), ``--checkpoint-dir`` and ``--scrub-rate
               0.25``: faults, retries, failover, checkpoints and the
               scrubber's cadence as scheduled, nothing confirmed or
               quarantined, the clean run's bit errors and paths.  Then the
               ``main`` of ``obs.smoke``, ``runtime.chaos_smoke`` and
               ``verify.scrub_smoke`` on the card, each exiting 0.  The
               phase's seconds against a budget of 60 s; the kernels line
               gains each kernel's ``launcher_launches`` per run;
 14. verify  — the BER farm and the tooling (``verify/farm.py``,
               ``verify/gate.py``, ``kernels/parity.py``,
               ``kernels/traffic.py``, ``obs/profile.py``): the farm's
               smoke grid through ``verify.farm.main`` and its gate (exit
               0); the ``--full`` grid (ccsds-k7, wifi-11a-r34, lte-tbcc,
               gsm-cs1 x reference, kernel, time_parallel, engine) at
               ``VERIFY_FULL_FRAMES`` frames of 512 stages a point, where
               the time-parallel plan engages; each (code, path)'s
               launches on one batch held to what ``decode_fn`` implies,
               its bits to the reference path's, and an integer-LLR batch
               whose kernel calls are held to their plain versions; the
               sharded farm on two logical shards ==
               the single-device farm, point for point; the parity main
               (exit 0); the traffic report and K2's launch geometry at
               its shape; an engine run with the recorder on, its bits
               those of the run with it off, every dispatch span carrying
               the modelled profile and its achieved fractions against
               the H100 entry (none above 1.0).  The phase's seconds
               against a budget of 60 s; the kernels line gains each
               kernel's ``verify_launches`` per run;
 15. lm      — the LM testbed's serving path (``models/lm.py``,
               ``serve/step.py``'s LM steps, ``launch/serve.py --service
               lm``), which launches none of the kernels above: TF32
               must be off; for each of the ten smoke configs at f32
               activations (parameters from one seeded CPU generator), a
               prefill of 2 x 32 positions and 4 decode steps on the card
               held to the same calls on the CPU (logits and caches, rtol
               = atol = 1e-4), and a teacher-forced decode held to
               ``forward(mode="train")`` at 1e-3; at full width and bf16,
               smollm-135m (prefill 8 x 4096 through the chunked
               attention, 64 greedy steps), mamba2-370m (4 x 2048, 16),
               hymba-1.5b (2 x 2048, past its window, 16) and
               mixtral-8x7b cut to 2 layers (2 x 512, 8) through
               ``make_prefill_step``/``make_decode_step``: prefill ms
               (CUDA events, median of 3 after a warm-up), decode
               tokens/s, peak memory, the card's name and power limit;
               non-finite logits or out-of-vocab tokens fail; then
               ``launch.serve --service lm --arch smollm-135m --tokens 8
               --streams 4`` on the card; last, smollm-135m's prefill and
               two decode steps under ``torch.profiler`` (kernels a call,
               device time, busy share against the unprofiled times).
               A ``{"lm": ...}`` JSON line
               before the kernels line; the phase's seconds against a
               budget of 60 s;
 16. train   — the LM testbed's training (``train/step.py``,
               ``optim/adamw.py``, ``optim/compress.py``,
               ``data/pipeline.py``'s ``TokenStream``, the checkpoint tree
               half, ``train/loop.py``, ``launch/train.py``), which
               launches none of the kernels above (the counts are zeroed
               before it and must be 0 after): TF32 must be off; for each
               of the ten smoke configs at f32 activations, the loss,
               every gradient and one AdamW step on 4 x 32 positions on
               the card held to the same calls on the CPU (loss rtol 1e-5;
               gradients and first moments within 1e-4 of each leaf's
               largest; new parameters within 1e-3 x lr where the
               gradient is at least 1e-3 of its leaf's largest, 2 x lr
               elsewhere), and on smollm-135m remat on against off and two
               microbatches against one at the same tolerances; at full
               width smollm-135m at train_4k's sequence of 4,096 with its
               global batch of 256 cut to 8, two microbatches, bf16
               activations, f32 parameters and optimiser: a warm-up step
               and 3 steps timed by CUDA events (median step ms, tokens/s,
               each loss finite, peak memory, the bf16 bound), then one
               step under ``torch.profiler`` (kernels, device busy share,
               the six longest kernels); mamba2-370m at 4 x 2,048, 2 steps
               (the SSD backward); the EF-int8 data-parallel step on 4
               logical shards of the card, the reference test's 60
               least-squares steps, held to the CPU run (losses,
               parameters, each shard's residual; rtol 1e-4, atol 1e-5)
               with its last loss under 0.05 x the first; the loop on the
               card, 6 steps straight against 3 and a resume through
               ``CheckpointManager`` (rtol 2e-4, atol 2e-5);
               ``launch.train --arch smollm-135m --smoke --steps 20``,
               its last logged loss under its first.  A ``{"train": ...}``
               JSON line before the kernels line; the phase's seconds
               against a budget of 60 s.
 17. shard   — the LM testbed's sharding (``launch/mesh.py``,
               ``distributed/sharding.py``, ``distributed/spmd.py``,
               ``distributed/pipeline.py``, ``restore(shardings=)``) on
               logical meshes of the card and the dry run
               (``launch/dryrun.py``, ``hlocount.py``, ``roofline.py``'s
               readers), which launch none of the kernels above (counts
               zeroed before, 0 after); TF32 must be off.  The dry run,
               ``--all --mesh both`` on ``meta`` in worker processes,
               starts first and is waited for last (exit 0; the
               ok/skipped/failed line, smollm-135m's train_4k row on
               ``roofline.H100``).  Meanwhile: (a) the ten smoke configs
               at f32, the sharded train step on a (2, 2) data/model mesh
               of the card == the unsharded step on the card bit for bit
               (2 microbatches; 1 on MoE) and the CPU's sharded step
               within phase 16's bounds; (b) smollm-135m at full width, 8
               x 4,096, bf16, (2, 2): a warm-up and a timed sharded step
               (CUDA events) held to the unsharded step with 2
               microbatches, with step ms, peak bytes, shard 0's state
               bytes and the collective records' wire bytes; (e) its
               state saved and restored onto (4, 1) and (1, 1) bit for
               bit, one step after each restore == one step from the
               saved state laid out there; (c) smollm-135m's sharded
               prefill of 8 x 4,096 and 16 greedy decode steps with the
               context-parallel cache (its sequence over "model"), fed
               the unsharded path's tokens: greedy tokens equal wherever
               the top two logits are more than 1e-3 apart, logits
               within 0.1; (d) the pipeline of smollm-135m's 30 layers
               in 5 stages of 6 on a ("pipe",) mesh, 8 x 4,096, 4
               microbatches: == the sequential stack a microbatch at a
               time, ms and ``bubble_fraction(5, 4)``.  A
               ``{"shard": ...}`` JSON line before the kernels line; the
               phase's seconds against a budget of 60 s.

Parity: at TROPICAL every kernel is held bit for bit to its plain version.
At LOGPROB the slot reduction is a logsumexp, whose expf/logf (CUDA) and
exp/log (PyTorch) need not round alike, so K1-LOGPROB and K3-LOGPROB are
held to their plain versions within ``logprob_bound``, the difference f32
rounding allows at the magnitudes the run reaches, on reachable entries;
the -1e9 of unreachable entries must be equal, and K1-LOGPROB's survivors
may differ only where the plain version's top two potentials are within
1e-3 of each other.  Each LOGPROB gate also prints how far the tropical
instantiation lands from the LOGPROB plain version on the same inputs;
at K3's soft tile and at the short depths that distance must be beyond
the bound, so a LOGPROB launch that reduced by the max fails the run.

Every kernel's ``bound_ms`` counts the operations its ACS step needs (the
distinct branch metrics once, then an add and a compare per slot, and at
LOGPROB R - 1 exponentials at the special-function rate), not
the fused matmul's dense multiply-adds: see ``acs_bound``.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

F_FULL, N_FULL = 512, 65536  # cell decode_64k: 512 streams x 65536 stages
F_SWEEP, T_SWEEP = 512, 1024
D_SWEEP, TT_SWEEP = 256, 32  # K2 sweep: ring depth and time tile, in steps
CHUNK_LEN = 4096  # streaming chunk, in stages
N_TILED = 2**20  # decode_1m: one stream of 2^20 stages
F_TP, N_TP = 16, 2**19  # decode_512k_f16: the time-parallel latency shape
TP_CELL = {}  # phase 9's AWGN codeword LLRs and their sequential decode, for phase 13
T_K3, TT_K3 = 4096, 64  # K3 sweep: radix steps and transfer tile
SWEEP_FRAMES = (1, 4, 16, 64, 256)  # budget sweep at N_FULL stages
F_SOFT = 64  # decode_soft("llr"): decode_64k's frame length at 1/8 of its frames
N_LIST, L_LIST = 4096, 4  # decode_soft("list"): stages and list size
F_TBCC, N_TBCC = 512, 64  # lte-tbcc tail-biting frames x bits
EBN0_DB, BER_LIMIT = 4.0, 1e-4
TBCC_BER_LIMIT = 1e-3  # 32768 tail-biting bits: the frames decode
# the separating gates: K3-LOGPROB at tiles of TT_SEP steps over the first
# T_SEP steps of the soft blocks, K1-LOGPROB's metrics after T1_SEP steps
T_SEP, TT_SEP, T1_SEP = 2048, 8, 8
PHI_TIE = 1e-3  # K1-LOGPROB's survivors may differ only at potential gaps under this
# K3's register layout where it can break, each (code, rho, tiles) on the
# integer and on the AWGN LLRs: a row's map from state to register
# rotates by rho of k-1 bits a step, so its period is (k-1)/gcd(k-1, rho):
# 3 at ccsds-k7, rho=2 (the tiles leave 0, 1 and 2 steps over whole
# periods), 6 at rho=1, 2 at rho=3; gsm-cs1 has S=16 (periods 2 and 4)
K3_LAYOUT = (("ccsds-k7", 2, (96, 64, 512)), ("ccsds-k7", 1, (96, 64, 65)),
             ("ccsds-k7", 3, (64, 65)), ("gsm-cs1", 2, (64, 65)),
             ("gsm-cs1", 3, (64, 67)))
K3_LAYOUT_FRAMES, K3_LAYOUT_TILES = 13, 8  # ragged at 2 and at 8 frames a block
# the shape sweep (phase 3): K1 and K2 against their plain versions at
# each code (k=6, 8 and 10 codes of no registry beside three of it: one
# 32-state frame a warp, a frame over two warps, over eight) and rho =
# 1..4; F ragged against every block shape; K2's depth and tile
SWEEP_CODES = (("ccsds-k7", None), ("gsm-cs1", None), ("lte-tbcc", None),
               ("k6 S=32", (6, (0o53, 0o75))), ("k8 S=128", (8, (0o371, 0o247))),
               ("k10 S=512", (10, (0o1167, 0o1545))))
SWEEP_F, SWEEP_STEPS, SWEEP_DEPTH, SWEEP_TILE = 37, 64, 32, 16
SEED = 0
# phase 11, the reference's standard-code cells (src/repro/configs/viterbi_k7.py):
# decode_64k_wifi_r34 and decode_64k_dvb_r78, 512 frames of 65536 kept
# LLRs: 49152 stages at rate 3/4 and 57344 at 7/8, less the 6-bit tail
F_CODES, N_MSG_WIFI, N_MSG_DVB = 512, 49146, 57338
N_TILED_CODES = 2**20  # kept LLRs of the wifi-11a-r34 tiled stream
F_TBCC_CELL, N_TBCC_CELL = 8192, 128  # decode_tbcc_blocks
F_TBCC_TP, TT_TBCC_TP = 64, 8  # time-parallel WAVA: blocks, transfer tile
# decode_64k_wifi_r34, the tiled stream and decode_tbcc_blocks at 6 dB;
# decode_64k_dvb_r78 at a fixed 7 dB (the rate-7/8 code leaves errors at 6)
EBN0_CODES, EBN0_DVB = 6.0, 7.0
CODES_BUDGET_S = 75  # phase 11's time budget, printed beside its seconds
# the H100's published f32 and HBM peaks come from the port's roofline
# entry (``repro_torch.roofline.H100``), read where a bound is computed
# special functions (expf, logf): 16 results a clock per SM for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs, 1.98 GHz boost clock
PEAK_SFU_OPS = 16 * 132 * 1.98e9
# dense bf16 on the tensor cores, NVIDIA's H100 SXM data sheet (no sparsity)
PEAK_BF16_FLOPS = 989e12


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


def ptxas_report(log: str):
    """One line per compiled kernel of an ``nvcc -Xptxas=-v`` log: its
    name with its template arguments, registers a thread, and spills."""
    import re

    def template_args(mangled, at):
        """The Itanium-mangled template arguments at ``at``: ints, bools
        and K2's ring type."""
        args = []
        if mangled[at:at + 1] != "I":
            return args
        at += 1
        while at < len(mangled):
            m = re.match(r"L([ib])(\d+)E", mangled[at:])
            if m:
                kind, value = m.groups()
                args.append(value if kind == "i" else ("true" if value == "1" else "false"))
                at += m.end()
            elif mangled[at] in "ai":
                args.append({"a": "int8_t", "i": "int32_t"}[mangled[at]])
                at += 1
            else:
                break
        return args

    name, spill, lines = "?", "", []
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = name = m.group(1)
            args = []
            # the kernel's length-prefixed identifier, then its arguments
            for d in re.finditer(r"(?=(\d{1,3}))", mangled):
                for n in range(1, len(d.group(1)) + 1):
                    at = d.start() + n
                    ident = mangled[at:at + int(d.group(1)[:n])]
                    if ident.endswith("_kernel") and ident[:1].isalpha() \
                            and mangled[at + len(ident):at + len(ident) + 1] == "I":
                        name = ident
                        args = template_args(mangled, at + len(ident))
            name += f"<{', '.join(args)}>" if args else ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers; {spill}")
    return lines


def host_ms(fn):
    """(result, host-clock ms) of ``fn``, bracketed by synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def acs_bound(w, n_llr, n_states, n_slots, frame_steps, entries, renorm,
              bytes_moved, extra_ops=0, semiring="tropical"):
    """(bound_ms, bound_by) of ``frame_steps`` ACS steps of one frame each,
    from the operations the step needs, not those the fused matmul does:
    the distinct branch metrics of W's LLR half once (a multiply-add, 2
    operations, per nonzero weight); then, for each of ``entries`` rows
    and each state, the add of the one predecessor metric for each of its
    ``n_slots`` slots and ``n_slots - 1`` compares (the slot max, whose
    argmax comes with them); with ``renorm``, the frame max and the
    subtraction (2S - 1).  At ``"logprob"`` each (row, state) also takes
    ``n_slots - 1`` exponentials (exp(best - best) = 1 needs none),
    counted at the special-function rate (``PEAK_SFU_OPS``), and 2 *
    ``n_slots`` f32 operations: the R - 1 differences, the R - 1 adds of
    1 + sum, the logarithm counted as one operation (a floor whichever
    pipe the accurate logf runs on) and the final add.  The f32 and the
    special-function times are each a floor, and the larger counts.  W's
    metric half is one-hot (checked here): its S - 1 zero products per
    potential add +-0 and are not counted."""
    S, R = n_states, n_slots
    pred = w[n_llr:]
    if not (torch.equal((pred != 0).sum(dim=0), torch.ones_like(pred[0], dtype=torch.int64))
            and torch.equal(pred.sum(dim=0), torch.ones_like(pred[0]))):
        fail("W's metric half is not one-hot: the operation count does not hold")
    branch = torch.unique(w[:n_llr].T, dim=0)
    per_step = (2 * int((branch != 0).sum()) + entries * S * (2 * R - 1)
                + ((2 * S - 1) if renorm else 0))
    sfu = 0
    if semiring == "logprob":
        per_step += entries * S * 2 * R
        sfu = frame_steps * entries * S * (R - 1)
    from repro_torch.roofline import H100

    t_ops = max((frame_steps * per_step + extra_ops) / H100.peak_flops,
                sfu / PEAK_SFU_OPS) * 1e3
    t_bytes = bytes_moved / H100.hbm_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def logprob_bound(steps, scale, n_llr, n_slots, renorm):
    """The largest |kernel - plain| difference that f32 rounding allows
    after ``steps`` LOGPROB ACS steps (u = 2^-24, the unit roundoff).  With
    ``renorm`` (K1) the reachable values stay within +-``scale`` at every
    step; without it (K3, from the identity) they grow by at most
    ``scale`` a step, so X_t = t * scale at step t.  Per step and per side,
    a_t = (n_llr + 2 + renorm) u X_t + (2R + 6) u: the potential rounds at
    most n_llr + 1 times at |value| <= X_t (the LLR terms in whatever
    order that side sums them, then the metric), the final add and a
    renorm subtraction once each; the R differences, exponentials (expf
    and exp each within 2 ulp) and their sum round relative to values of
    at most R, which moves the log by at most (R + 5) u, and the log
    rounds by at most u ln R < (R + 1) u.  The logsumexp is monotone and
    shifts with its inputs, so it widens the spread (max - min over the
    entries) of the two sides' difference by nothing, and each step's
    roundings widen it by at most 2 x 2 a_t.  Subtracting each side's own
    max (a renorm, or K3's final shift) leaves the difference within its
    spread, plus one rounding at |value| <= 2 X_T on each side."""
    u = 2.0 ** -24
    rounds = n_llr + 2 + int(renorm)
    sum_x = steps * scale if renorm else scale * steps * (steps + 1) / 2
    x_end = scale if renorm else steps * scale
    return 4 * (rounds * u * sum_x + steps * (2 * n_slots + 6) * u) + 4 * u * x_end


def path_metric_ties(llrs, bits_a, bits_b, spec):
    """Where two decodes of the same LLRs differ: (frames that differ,
    largest |metric_a - metric_b| over them, largest |metric|), the metric
    being the float64 correlation of the LLRs with each decode's
    re-encoded BPSK symbols, which an ML decoder maximises.  Equal
    metrics mean both decodes are ML paths (a tie)."""
    from repro_torch.core import conv_encode_torch
    from repro_torch.core.channel import bpsk

    rows = (bits_a != bits_b).any(dim=1).nonzero()[:, 0]
    if rows.numel() == 0:
        return 0, 0.0, 0.0
    x = llrs[rows].double()
    ma = (x * bpsk(conv_encode_torch(bits_a[rows], spec)).double()).sum(dim=(1, 2))
    mb = (x * bpsk(conv_encode_torch(bits_b[rows], spec)).double()).sum(dim=(1, 2))
    return (rows.numel(), (ma - mb).abs().max().item(),
            torch.maximum(ma.abs(), mb.abs()).max().item())


def library_forward(blocks, lam0, w, n_states, n_slots, semiring="tropical"):
    """Yardstick only: the K1 step as stock PyTorch calls, one step at a
    time: torch.matmul, then torch.max for the slot max and argmax
    (tropical), or torch.logsumexp over the slots and torch.argmax for
    the first argmax (logprob); the renorm subtracts the frame's max."""
    T, F, _ = blocks.shape
    phi = torch.empty((T, F, n_states), dtype=torch.int8, device=blocks.device)
    lam = lam0
    for t in range(T):
        pot = torch.matmul(torch.cat([blocks[t], lam], dim=1), w)
        slots = pot.view(F, n_states, n_slots)
        if semiring == "logprob":
            new, idx = torch.logsumexp(slots, dim=-1), slots.argmax(dim=-1)
        else:
            new, idx = slots.max(dim=-1)
        phi[t] = idx
        lam = new - new.amax(dim=-1, keepdim=True)
    return lam, phi


def k2_random_ring(gen, D, F, pack, dev):
    """An entry ring of random survivors: whole int32 words, or slots."""
    if pack:
        return torch.randint(-2**31, 2**31, (D, F, 4), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
    return torch.randint(0, 4, (D, F, 64), generator=gen, device=dev,
                         dtype=torch.int8)


def dispatched(fn):
    """(result of ``fn``, {path: count}) of the decoder dispatches it made."""
    from repro_torch.obs import MetricsRegistry, set_default_registry

    reg = MetricsRegistry()
    old = set_default_registry(reg)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        set_default_registry(old)
    return out, {labels["path"]: int(n) for labels, n
                 in reg.counter("decoder_dispatch_total").series()}


def k3_layout_inputs(llrs, gen):
    """For each case of ``K3_LAYOUT``: (label, tables, W, tile, integer
    blocks, AWGN blocks), ``K3_LAYOUT_TILES`` tiles of
    ``K3_LAYOUT_FRAMES`` frames; the AWGN blocks are phase 4's LLRs."""
    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables
    from repro_torch.core.viterbi import blocks_from_llrs

    for code, rho, tiles in K3_LAYOUT:
        tb = build_acs_tables(get_code(code).spec, rho)
        w = torch.as_tensor(tb.fused_w, device=llrs.device)
        for tt in tiles:
            T = K3_LAYOUT_TILES * tt
            ints = torch.randint(-8, 9, (T, K3_LAYOUT_FRAMES, tb.llr_block),
                                 generator=gen, device=llrs.device).float()
            noisy = blocks_from_llrs(llrs[:K3_LAYOUT_FRAMES, :T * rho], rho).contiguous()
            yield f"{code} rho={rho}", tb, w, tt, ints, noisy


def unpack_slots(words, n_slots):
    """(..., S/16) packed int32 survivor words -> (..., S) int64 slots
    (``kernel_geometry.pack_slots`` undone)."""
    from repro_torch.core.kernel_geometry import SLOT_BITS

    shifts = SLOT_BITS[n_slots] * torch.arange(16, device=words.device)
    slots = ((words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & (n_slots - 1)
    return slots.reshape(*words.shape[:-1], -1)


def phi_tie_gap(phi_k, phi_p, blocks, lam0, w, tables, renorm, packed):
    """(slots in which two LOGPROB survivor tensors of the same inputs
    differ, the largest gap between the top two plain potentials among
    them): the potentials from the metrics of the plain LOGPROB forward
    (``soft._alpha_scan``), one step before each differing slot."""
    from repro_torch.core import soft
    from repro_torch.core.viterbi import AcsPrecision

    R = tables.n_slots
    if packed:
        phi_k, phi_p = unpack_slots(phi_k, R), unpack_slots(phi_p, R)
    mism = (phi_k.to(torch.int64) != phi_p.to(torch.int64)).nonzero()
    if mism.numel() == 0:
        return 0, 0.0
    alphas = soft._alpha_scan(blocks, lam0, tables, AcsPrecision(renorm=renorm))
    t_i, f_i, j_i = mism.unbind(1)
    prev = torch.where((t_i > 0)[:, None], alphas[(t_i - 1).clamp(min=0), f_i],
                       lam0[f_i])
    xcat = torch.cat([blocks[t_i, f_i], prev], dim=1)
    cols = j_i[:, None] * R + torch.arange(R, device=blocks.device)[None]
    pot = (xcat[:, :, None] * w[:, cols].permute(1, 0, 2)).sum(dim=1)
    top = pot.topk(2, dim=-1).values
    return mism.shape[0], (top[:, 0] - top[:, 1]).max().item()


def shape_sweep_phase(dev):
    """Phase 3's shape sweep: K1 and K2 bit for bit against their plain
    versions at each (code, rho) of ``SWEEP_CODES``, on integer and AWGN
    LLRs, and K1-LOGPROB within ``logprob_bound`` of its plain version
    there; then a W that is not the one-hot must raise before any launch,
    at both semirings.  Its inputs come from a generator of its own, so
    the later phases draw what they drew without it.  Returns the largest
    |metric| difference of the tropical kernels (0.0 when bit-identical)
    and of K1-LOGPROB."""
    import math

    from repro_torch.codes import get_code
    from repro_torch.core import CodeSpec, build_acs_tables, conv_encode_torch
    from repro_torch.core.channel import awgn, bpsk, llr
    from repro_torch.core.kernel_geometry import gather_block_shape
    from repro_torch.core.viterbi import blocks_from_llrs
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import acs_decode_fused_ref, acs_forward_ref

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    k1, k2 = viterbi_acs.acs_forward, viterbi_acs.acs_decode_fused
    f32, bf16 = torch.float32, torch.bfloat16
    F, T, D, TT = SWEEP_F, SWEEP_STEPS, SWEEP_DEPTH, SWEEP_TILE
    err = lp_err = 0.0

    def same(label, got, want):
        nonlocal err
        got = [g.to(want[0].device) for g in got]
        for g, p in zip(got, want):
            if g.is_floating_point():
                err = max(err, (g - p).abs().max().item())
        if not all(torch.equal(g, p) for g, p in zip(got, want)):
            fail(f"{label} differs from its plain version")

    def ring(S, R, depth, pack):
        if pack:
            return torch.randint(-2**31, 2**31, (depth, F, S // 16), generator=gen,
                                 device=dev, dtype=torch.int64).to(torch.int32)
        return torch.randint(0, R, (depth, F, S), generator=gen, device=dev,
                             dtype=torch.int8)

    for name, custom in SWEEP_CODES:
        spec = CodeSpec(k=custom[0], polys=custom[1]) if custom else get_code(name).spec
        for rho in (1, 2, 3, 4):
            tb = build_acs_tables(spec, rho)
            S, R, B = tb.n_states, tb.n_slots, tb.llr_block
            w = torch.as_tensor(tb.fused_w, device=dev)
            packs = (False, True) if S % 16 == 0 and R <= 4 else (False,)
            ints = torch.randint(-2, 3, (T, F, B), generator=gen, device=dev).float()
            msg = torch.randint(0, 2, (F, T * rho), generator=gen, device=dev)
            noisy = blocks_from_llrs(llr(awgn(gen, bpsk(conv_encode_torch(msg, spec)),
                                              EBN0_DB, spec.rate), EBN0_DB, spec.rate),
                                     rho).contiguous()
            lam0 = torch.zeros((F, S), device=dev)  # every state open: ties
            label = f"{name} rho={rho}"
            n1 = n2 = 0
            for mm in (f32, bf16):
                for pack in packs:
                    for renorm in (True, False):
                        kw = dict(n_states=S, n_slots=R, matmul_dtype=mm,
                                  renorm=renorm, pack_survivors=pack)
                        same(f"K1 {label} {kw}", k1(ints, lam0, w, **kw),
                             acs_forward_ref(ints, lam0, w, **kw))
                        n1 += 1
            kw = dict(n_states=S, n_slots=R)
            same(f"K1 {label} AWGN", k1(noisy, lam0, w, **kw),
                 acs_forward_ref(noisy.cpu(), lam0.cpu(), w.cpu(), **kw))
            # K1-LOGPROB: from all-equal metrics the renormalised ones stay
            # within d steps' spread (every state reaches every state in d
            # steps), the potentials one step beyond; raw ones grow by at
            # most m a step
            d = -(-(spec.k - 1) // rho)
            lp_cases = []
            for kind, x, renorm, pack in (("integer", ints, True, False),
                                          ("integer", ints, False, packs[-1]),
                                          ("AWGN", noisy, True, False)):
                m = x.abs().sum(dim=-1).max().item() + math.log(R)
                kw = dict(n_states=S, n_slots=R, renorm=renorm, pack_survivors=pack,
                          semiring="logprob")
                lam_k, phi_k = k1(x, lam0, w, **kw)
                lam_p, phi_p = acs_forward_ref(x, lam0, w, **kw)
                e, bound = logprob_case(
                    f"K1-LOGPROB vs plain {label}, {kind} LLRs, renorm={renorm} "
                    f"packed={pack}", lam_k, lam_p, T, d * (2 * m) + m if renorm else m,
                    B, R, renorm, quiet=True)
                lp_err = max(lp_err, e)
                n_diff, gap = phi_tie_gap(phi_k, phi_p, x, lam0, w, tb, renorm, pack)
                if not gap <= PHI_TIE:
                    fail(f"K1-LOGPROB {label} survivors differ at a potential gap of {gap}")
                lp_cases.append(f"{kind} renorm={renorm} packed={pack}: err {e:.3g} "
                                f"(bound {bound:.3g}), {n_diff} slots differ (gap {gap:.3g})")
            kw2 = dict(n_states=S, n_slots=R, k=spec.k, rho=rho)
            for pack in packs:
                for steps, tile, depth, mm, renorm in ((T, TT, D, f32, True),
                                                       (T, TT, D, bf16, False),
                                                       (TT, TT, D, f32, True),
                                                       (8, 1, 5, f32, True)):
                    hist0 = ring(S, R, depth, pack)
                    kw = dict(kw2, time_tile=tile, matmul_dtype=mm, renorm=renorm,
                              pack_survivors=pack)
                    same(f"K2 {label} T={steps} TT={tile} {kw}",
                         k2(ints[:steps], lam0, hist0, w, **kw),
                         acs_decode_fused_ref(ints[:steps], lam0, hist0, w, **kw))
                    n2 += 1
            hist0 = ring(S, R, D, False)
            kw = dict(kw2, time_tile=TT)
            same(f"K2 {label} AWGN", k2(noisy, lam0, hist0, w, **kw),
                 acs_decode_fused_ref(noisy.cpu(), lam0.cpu(), hist0.cpu(), w.cpu(), **kw))
            torch.cuda.synchronize()
            frames, threads = gather_block_shape(S)
            print(f"K1 and K2 vs plain {label} (S={S} R={R} B={B}, F={F}; "
                  f"{frames} frames of {threads // frames} threads a block): "
                  f"{n1} K1 and {n2} K2 cases on integer LLRs "
                  f"(K2 at TT={TT}, T=TT and TT=1), one each on AWGN LLRs (plain "
                  f"on the CPU): bit-identical; K1-LOGPROB within the bound: "
                  + "; ".join(lp_cases), flush=True)

    # K2 where a block holds 32 frames (S = 4) or 64 (S = 2, two a lane of
    # the walk warp): a tile of one step is far shorter than the walk of a
    # deep window, so the next tile's start states are written while the
    # walk of this one still reads its own
    for k, polys in ((2, (0o3, 0o1)), (3, (0o7, 0o5))):
        spec = CodeSpec(k=k, polys=polys)
        tb = build_acs_tables(spec, 1)
        S, R, B = tb.n_states, tb.n_slots, tb.llr_block
        w = torch.as_tensor(tb.fused_w, device=dev)
        n_frames, depth = 130, 512
        ints = torch.randint(-2, 3, (T, n_frames, B), generator=gen, device=dev).float()
        lam0 = torch.zeros((n_frames, S), device=dev)
        hist0 = torch.randint(0, R, (depth, n_frames, S), generator=gen, device=dev,
                              dtype=torch.int8)
        kw = dict(n_states=S, n_slots=R, k=k, rho=1, time_tile=1)
        same(f"K2 S={S} TT=1 D={depth}", k2(ints, lam0, hist0, w, **kw),
             acs_decode_fused_ref(ints, lam0, hist0, w, **kw))
        torch.cuda.synchronize()
        frames, _ = gather_block_shape(S)
        print(f"K2 vs plain S={S} (k={k}, rho=1, F={n_frames}, T={T}, TT=1, "
              f"D={depth}; {frames} frames a block): bit-identical", flush=True)

    # a W whose metric half is not the shift register's one-hot
    tb = build_acs_tables(get_code("ccsds-k7").spec, 2)
    bad = torch.as_tensor(tb.fused_w, device=dev).clone()
    bad[4:] = bad[4:].roll(1, dims=0)
    blocks = torch.zeros((TT, F, 4), device=dev)
    lam0 = torch.zeros((F, 64), device=dev)
    before = (k1.launches, k2.launches)
    for kernel, call in (
        ("K1", lambda: k1(blocks, lam0, bad, n_states=64, n_slots=4)),
        ("K1-LOGPROB", lambda: k1(blocks, lam0, bad, n_states=64, n_slots=4,
                                  semiring="logprob")),
        ("K2", lambda: k2(blocks, lam0, ring(64, 4, D, True), bad, n_states=64,
                          n_slots=4, k=7, rho=2, time_tile=TT, pack_survivors=True)),
    ):
        try:
            call()
        except ValueError as exc:
            print(f"{kernel} on a W whose metric half is not the one-hot: "
                  f"ValueError before any launch ({exc})")
        else:
            fail(f"{kernel} took a W whose metric half is not the one-hot")
    if (k1.launches, k2.launches) != before:
        fail("a refused W still launched a kernel")
    print(f"shape sweep took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return err, lp_err


def time_parallel_phase(decoder, llrs, gen, tables, w):
    """Phase 9: K3 against its plain version, the time-parallel
    decode_batch at the decode_512k_f16 shape, its stage times, the
    underfill budget sweep and the auto-selection; returns K3's row of
    the kernels line."""
    from repro_torch.core import conv_encode_torch
    from repro_torch.core import timeparallel as tp
    from repro_torch.core.backend import device_underfill_rows
    from repro_torch.core.channel import awgn, bpsk, llr
    from repro_torch.core.kernel_geometry import k3_block_frames, k3_in_registers
    from repro_torch.core.viterbi import blocks_from_llrs, init_metric, traceback
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import transfer_matrix_ref

    t_phase = time.perf_counter()
    dev = llrs.device
    spec = decoder.spec
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    k3, k1 = viterbi_acs.transfer_matrix, viterbi_acs.acs_forward
    k3_err = 0.0

    def k3_case(label, blocks, w=w, tb=tables, plain_on_cpu=False, **kw):
        """K3 bit for bit against its plain version.  With
        ``plain_on_cpu`` (AWGN LLRs, whose sums round in the order they
        are taken) against the plain version on the CPU, whose matmul sums
        W's rows in k order as K3 does; on the card the plain version's
        matmul picks its order by the shape."""
        nonlocal k3_err
        kw = dict(n_states=tb.n_states, n_slots=tb.n_slots, **kw)
        got = k3(blocks, w, **kw)
        want = transfer_matrix_ref(blocks, w, **kw)
        torch.cuda.synchronize()
        note = ""
        if plain_on_cpu:
            cpu = transfer_matrix_ref(blocks.cpu(), w.cpu(), **kw).to(blocks.device)
            note = (f"; on the card's plain version "
                    f"{'bit-identical' if torch.equal(got, want) else 'not'}, "
                    f"which is {'' if torch.equal(want, cpu) else 'not '}the CPU's")
            want = cpu
        err = (got - want).abs().max().item()
        k3_err = max(k3_err, err)
        same = torch.equal(got, want)
        where = ("registers" if k3_in_registers(tb.n_states, tb.n_slots)
                 else "shared memory")
        print(f"K3 vs plain{' on the CPU' if plain_on_cpu else ''} {label} "
              f"(F={blocks.shape[1]} T={blocks.shape[0]} "
              f"TT={kw['transfer_tile']}; {k3_block_frames(tb.n_states)} "
              f"frames a block, rows in {where}): "
              f"{'bit-identical' if same else 'DIFFERENT'}{note}", flush=True)
        if not same:
            fail(f"K3 differs from its plain version ({label}), max |M| diff {err}")
        return got

    blocks = torch.randint(
        -8, 9, (T_K3, F_TP, B), generator=gen, device=dev
    ).float()
    for mm in (torch.float32, torch.bfloat16):
        for split in (False, True):
            for carry in (torch.float32, torch.bfloat16):
                k3_case(f"mm={str(mm)[6:]} split_dot={split} "
                        f"carry={str(carry)[6:]}", blocks,
                        transfer_tile=TT_K3, matmul_dtype=mm,
                        split_dot=split, carry_dtype=carry)
    k3_case("ragged F", blocks[:, :F_TP - 3].contiguous(), transfer_tile=TT_K3)
    for label, tb, wc, tt_case, ints, noisy in k3_layout_inputs(llrs, gen):
        k3_case(f"{label}, integer LLRs", ints, w=wc, tb=tb, transfer_tile=tt_case)
        k3_case(f"{label}, AWGN LLRs", noisy, w=wc, tb=tb, plain_on_cpu=True,
                transfer_tile=tt_case)

    # the latency shape: 16 zero-terminated frames x 2^19 stages
    n_info = N_TP - (spec.k - 1)
    info = torch.randint(0, 2, (F_TP, n_info), generator=gen, device=dev)
    msg = torch.cat(
        [info, torch.zeros(F_TP, spec.k - 1, dtype=info.dtype, device=dev)],
        dim=1,
    )
    llrs_tp = llr(awgn(gen, bpsk(conv_encode_torch(msg, spec)), EBN0_DB,
                       spec.rate), EBN0_DB, spec.rate)
    quant = torch.clamp(torch.round(llrs_tp), -16, 16)
    T = N_TP // 2
    tt = decoder._time_parallel_tile(F_TP, T, True)
    print(f"decode_512k_f16 input: llrs {tuple(llrs_tp.shape)} "
          f"{llrs_tp.numel() * 4 / 2**20:.0f} MiB; transfer tile {tt} steps, "
          f"{T // tt} tiles", flush=True)

    k3.launches = k1.launches = 0
    bits, paths = dispatched(lambda: decoder.decode_batch(llrs_tp, time_parallel=True))
    k3_launches, k1_launches = k3.launches, k1.launches
    print(f"decode_batch(time_parallel=True): dispatch {paths}; "
          f"K3 launches {k3_launches}, K1 launches {k1_launches}")
    if paths != {"time_parallel": 1}:
        fail(f"decode_batch(time_parallel=True) dispatched {paths}")
    if (k3_launches, k1_launches) != (1, 1):
        fail(f"the time-parallel decode launched K3 {k3_launches} and K1 "
             f"{k1_launches} times, not once each")
    if bits.shape != (F_TP, N_TP) or bits.device.type != "cuda":
        fail(f"time-parallel decode_batch returned {tuple(bits.shape)} on {bits.device}")
    errors = int((bits[:, :n_info] != info).sum())
    ber = errors / (F_TP * n_info)
    print(f"time-parallel AWGN Eb/N0={EBN0_DB} dB: {errors} bit errors in "
          f"{F_TP * n_info} bits, BER {ber:.3e} (limit {BER_LIMIT:g})")
    if not ber <= BER_LIMIT:
        fail(f"time-parallel BER {ber:.3e} above {BER_LIMIT:g}")
    bits_seq, seq_ms = host_ms(
        lambda: decoder.decode_batch(llrs_tp, time_parallel=False))
    print(f"AWGN: {int((bits != bits_seq).sum())} bits differ from the "
          "sequential path")
    # phase 13 holds the time-sharded decode to this sequential decode
    TP_CELL.update(llrs=llrs_tp, bits_seq=bits_seq, info=info)
    del bits_seq
    bits_q = decoder.decode_batch(quant, time_parallel=True)
    bits_qs = decoder.decode_batch(quant, time_parallel=False)
    if not torch.equal(bits_q, bits_qs):
        fail("integer LLRs: the time-parallel and the sequential path decode "
             f"differently ({int((bits_q != bits_qs).sum())} bits)")
    print("integer LLRs: time-parallel bits == sequential bits")
    del bits_q, bits_qs
    walls = sorted(
        host_ms(lambda: decoder.decode_batch(llrs_tp, time_parallel=True))[1]
        for _ in range(3)
    )
    wall = walls[1]

    # the stages, on the integer LLRs, with CUDA events
    blocks = blocks_from_llrs(quant, 2).contiguous()
    prec = decoder.precision
    kw = dict(n_states=S, n_slots=R, transfer_tile=tt)
    ops_w = viterbi_acs.gather_operands(w, B, S, R)
    k3_ms = cuda_ms(lambda: k3(blocks, w, operands=ops_w, **kw))
    plain_ms = cuda_ms(lambda: transfer_matrix_ref(blocks, w, **kw),
                       warmup=lambda: transfer_matrix_ref(blocks[:tt], w, **kw))
    m = k3_case("decode_512k_f16 shape", blocks, transfer_tile=tt)
    lam0 = init_metric(F_TP, S, 0, device=dev)
    prefix_ms = cuda_ms(lambda: tp.prefix_entry_metrics(m, lam0))
    entry = tp.prefix_entry_metrics(m, lam0)
    recovery_ms = cuda_ms(lambda: tp._recovery(blocks, entry, tables, prec, tt, True, False))
    lam_fin, phis = tp._recovery(blocks, entry, tables, prec, tt, True, False)
    fs = lam_fin[-1].argmax(dim=-1)
    suffix_ms = cuda_ms(lambda: tp._suffix_to_final(m, fs))
    starts = (entry + tp._suffix_to_final(m, fs)).argmax(dim=-1)
    exits = torch.cat([starts[1:], fs[None]], dim=0).reshape(-1)
    tb_ms = cuda_ms(lambda: traceback(phis, exits, tables),
                    warmup=lambda: traceback(phis[:8], exits, tables))
    del phis, blocks, lam_fin
    print(f"time K3 transfer_matrix: {k3_ms:.3f} ms (F={F_TP} x T={T} steps, TT={tt})")
    print(f"time prefix scan (prefix_entry_metrics): {prefix_ms:.3f} ms")
    print(f"time suffix scan (_suffix_to_final): {suffix_ms:.3f} ms")
    print(f"time recovery (tile layout + K1 over {T // tt * F_TP} frames x {tt} steps): "
          f"{recovery_ms:.3f} ms")
    print(f"time time-parallel traceback ({tt} steps x {T // tt * F_TP} rows): {tb_ms:.3f} ms")
    print(f"time time-parallel decode_batch wall: {wall:.3f} ms (median of "
          f"{', '.join(f'{x:.3f}' for x in walls)}; K3 {k3_ms / wall:.1%})")
    print(f"time-parallel decoded: {F_TP * N_TP / wall / 1e3:.3f} Mb/s")
    print(f"sequential decode_batch at this shape (yardstick, one sample): "
          f"{seq_ms:.3f} ms, {F_TP * N_TP / seq_ms / 1e3:.3f} Mb/s")
    print(f"time K3 plain version (transfer_matrix_ref): {plain_ms:.3f} ms")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    # K3's bound: the ACS step with S entry rows and no renorm, plus each
    # (tile, frame)'s final max and subtraction over S x S
    k3_bound, k3_bound_by = acs_bound(
        w, B, S, R, F_TP * T, S, False,
        quant.numel() * 4 + w.numel() * 4 + m.numel() * 4,
        extra_ops=m.numel() * 2,
    )
    print(f"K3 bound: {k3_bound:.3f} ms ({k3_bound_by}); K3 at "
          f"{k3_bound / k3_ms:.2%} of it")
    del m, entry, quant, llrs_tp

    # the budget of device_underfill_rows: time-parallel against sequential
    # decode_batch at N_FULL stages, in turns, 3 samples each
    budget = 0
    decoder.decode_batch(llrs[:1], time_parallel=True)  # warm-up at this length
    for F in SWEEP_FRAMES:
        x = llrs[:F]
        tps, seqs = [], []
        for _ in range(3):
            b_tp, ms = host_ms(lambda: decoder.decode_batch(x, time_parallel=True))
            tps.append(ms)
            b_seq, ms = host_ms(lambda: decoder.decode_batch(x, time_parallel=False))
            seqs.append(ms)
        faster = all(a < b for a, b in zip(tps, seqs))
        if faster:
            budget = max(budget, F * S)
        print(f"budget sweep F={F} (F*S={F * S}) x {N_FULL} stages: "
              f"time-parallel ms {', '.join(f'{t:.3f}' for t in tps)}; "
              f"sequential ms {', '.join(f'{t:.3f}' for t in seqs)}; "
              f"time-parallel faster in every sample: {faster}", flush=True)
        # the bits of the two paths, on the AWGN input and on its
        # integer-quantised copy; where they differ, whether by a tie
        xq = torch.clamp(torch.round(x), -16, 16)
        b_qtp = decoder.decode_batch(xq, time_parallel=True)
        b_qseq = decoder.decode_batch(xq, time_parallel=False)
        for label, xin, a, b in (("AWGN", x, b_tp, b_seq),
                                 ("integer", xq, b_qtp, b_qseq)):
            rows, gap, mag = path_metric_ties(xin, a, b, spec)
            print(f"  F={F} {label} LLRs: {int((a != b).sum())} bits in "
                  f"{rows} frames differ from the sequential path"
                  + (f"; largest path-metric gap {gap!r} at |metric| up to "
                     f"{mag!r} (0.0 is a tie: both are ML paths)" if rows else ""))
        del b_tp, b_seq, b_qtp, b_qseq, xq
    rows = device_underfill_rows(dev)
    print(f"budget from this sweep: {budget} rows; device_underfill_rows(cuda) "
          f"= {rows} ({'agrees' if budget == rows else 'differs'})")

    # auto-selection: the path the budget implies at F_TP, batch at decode_64k
    want = "time_parallel" if F_TP * S <= rows else "batch"
    _, paths = dispatched(lambda: decoder.decode_batch(llrs[:F_TP]))
    _, paths_64k = dispatched(lambda: decoder.decode_batch(llrs))
    print(f"auto-selection: F={F_TP} x {N_FULL} stages dispatches {paths} "
          f"(budget implies {want}); decode_64k dispatches {paths_64k}")
    if paths != {want: 1}:
        fail(f"auto-selection at F={F_TP} dispatched {paths}, not {want}")
    if paths_64k != {"batch": 1}:
        fail(f"decode_64k dispatched {paths_64k}, not batch")
    print(f"phase 9 (timepar) took {time.perf_counter() - t_phase:.1f} s")

    return {
        "name": "K3 transfer_matrix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/transfer_matrix.cu",
        "replaces": "src/repro/kernels/viterbi_acs.py:624",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "shape": f"decode_batch(time_parallel=True): F={F_TP} x {N_TP} stages, "
                 f"T={T} steps, TT={tt}, N={T // tt}",
        "plain_ms": plain_ms,
        "bound_ms": k3_bound,
        "bound_by": k3_bound_by,
        "library_ms": None,
    }


def logprob_case(label, got, want, steps, scale, n_llr, n_slots, renorm,
                 control=None, separate=False, quiet=False):
    """Hold a LOGPROB kernel's output to its plain version's: reachable
    entries (> -1e8) the same on both sides and within ``logprob_bound``,
    unreachable ones equal.  ``control`` is the tropical instantiation's
    output on the same inputs, a stand-in for a LOGPROB launch that
    reduces by the max: its distance from the plain version is printed
    beside the bound, and with ``separate`` the gate must reject it (else
    this gate could not tell the two semirings apart).  ``quiet`` prints
    nothing unless the gate fails.  Returns (max abs error, bound)."""
    torch.cuda.synchronize()
    reach = want > -1e8
    if not torch.equal(got > -1e8, reach):
        fail(f"{label}: the reachable entries differ from the plain version's")
    if not torch.equal(got[~reach], want[~reach]):
        fail(f"{label}: the -1e9 entries differ from the plain version's")
    diff = (got - want)[reach].abs()
    err = diff.max().item() if diff.numel() else 0.0
    big = want[reach].abs() > 1.0
    rel = (diff[big] / want[reach][big].abs()).max().item() if big.any() else 0.0
    bound = logprob_bound(steps, scale, n_llr, n_slots, renorm)
    if quiet and err <= bound:
        return err, bound
    print(f"{label}: max abs err {err!r}, max rel err {rel!r} (entries above 1 "
          f"in magnitude) over {int(reach.sum())} reachable of {reach.numel()} "
          f"entries; bound {bound!r} ({steps} steps at values up to "
          f"{scale * (1 if renorm else steps):.1f}); "
          f"{'within' if err <= bound else 'OUTSIDE'}", flush=True)
    if not err <= bound:
        fail(f"{label}: max abs err {err} beyond the f32 rounding bound {bound}")
    if control is not None:
        both = reach & (control > -1e8)
        gap = (control - want)[both].abs().max().item() if both.any() else 0.0
        print(f"  control, the tropical instantiation on the same inputs: max abs "
              f"distance {gap!r} from the LOGPROB plain version; "
              f"{'rejected' if gap > bound else 'NOT rejected'} by this gate"
              + ("" if separate else " (printed, not required)"), flush=True)
        if separate and not gap > bound:
            fail(f"{label}: the gate does not reject the tropical instantiation "
                 f"(distance {gap} within the bound {bound})")
    return err, bound


def soft_phase(decoder, llrs, info, bits_batch, quant, gen, tables, w, sweep_err):
    """Phase 10: decode_soft at full width, K3-LOGPROB and K1-LOGPROB
    against their plain versions, the list decode and lte-tbcc; returns
    the K1-LOGPROB and K3-LOGPROB rows of the kernels line (K1-LOGPROB's
    error the larger of this phase's and ``sweep_err``, the shape
    sweep's)."""
    import math

    from repro_torch.core import ViterbiDecoder, conv_encode_torch
    from repro_torch.core import soft
    from repro_torch.core import timeparallel as tp
    from repro_torch.core.channel import awgn, bpsk, llr
    from repro_torch.core.kernel_geometry import pick_transfer_tile
    from repro_torch.core.semiring import LOGPROB
    from repro_torch.core.trellis import build_reverse_tables
    from repro_torch.core.viterbi import blocks_from_llrs, forward_fused, init_metric
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import acs_forward_ref, transfer_matrix_ref

    t_phase = time.perf_counter()
    dev = llrs.device
    spec = decoder.spec
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    k1, k3 = viterbi_acs.acs_forward, viterbi_acs.transfer_matrix
    prec = decoder.precision
    x = llrs[:F_SOFT]
    n_info = N_FULL - (spec.k - 1)
    T = N_FULL // 2
    tt = pick_transfer_tile(T, decoder.transfer_tile)
    N = T // tt
    print(f"decode_soft input: llrs {tuple(x.shape)}, T'={T} steps, TT={tt}, "
          f"N={N} tiles", flush=True)

    # the main path: decode_soft(output="llr"), counts zeroed just before
    for kernel in (k1, k3):
        kernel.launches = kernel.logprob_launches = 0
    out, paths = dispatched(lambda: decoder.decode_soft(x))
    k3_launches, k3_all, k1_all = k3.logprob_launches, k3.launches, k1.launches
    print(f"decode_soft(llr): dispatch {paths}; K3-LOGPROB launches "
          f"{k3_launches} (K3 launches in all {k3_all}, K1 {k1_all})")
    if paths != {"soft": 1}:
        fail(f"decode_soft dispatched {paths}")
    if (k3_launches, k3_all, k1_all) != (1, 1, 0):
        fail(f"decode_soft launched K3-LOGPROB {k3_launches} times (K3 {k3_all}, "
             f"K1 {k1_all}), not one K3-LOGPROB launch")
    if out.shape != (F_SOFT, N_FULL) or out.dtype != torch.float32 \
            or not bool(torch.isfinite(out).all()):
        fail(f"decode_soft returned {tuple(out.shape)} {out.dtype}, or non-finite LLRs")
    hard = (out < 0).to(torch.int32)
    errors = int((hard[:, :n_info] != info[:F_SOFT]).sum())
    ber = errors / (F_SOFT * n_info)
    differ = int((hard != bits_batch[:F_SOFT]).sum())
    print(f"soft AWGN Eb/N0={EBN0_DB} dB: {errors} bit errors in "
          f"{F_SOFT * n_info} bits, BER {ber:.3e} (limit {BER_LIMIT:g}); "
          f"{differ} bits differ from decode_batch's (MAP per bit against "
          f"the ML sequence)")
    if not ber <= BER_LIMIT:
        fail(f"decode_soft BER {ber:.3e} above {BER_LIMIT:g}")
    del hard

    # K3-LOGPROB against its plain version on decode_soft's own blocks
    blocks = (blocks_from_llrs(x, 2) * 0.5).contiguous()
    m_scale = blocks.abs().sum(dim=-1).max().item() + math.log(R)
    kw = dict(n_states=S, n_slots=R, transfer_tile=tt, semiring="logprob")
    ops_w = viterbi_acs.gather_operands(w, B, S, R)
    k3_ms = cuda_ms(lambda: k3(blocks, w, operands=ops_w, **kw))
    m = k3(blocks, w, **kw)
    res = {}
    k3_plain_ms = cuda_ms(
        lambda: res.update(m=transfer_matrix_ref(blocks, w, **kw)),
        warmup=lambda: transfer_matrix_ref(blocks[:tt], w, **kw))
    kw_trop = dict(kw, semiring="tropical")
    k3_err, _ = logprob_case(
        f"K3-LOGPROB vs plain (F={F_SOFT} T={T} TT={tt})", m, res.pop("m"),
        tt, m_scale, B, R, False, control=k3(blocks, w, **kw_trop), separate=True)
    # the same instantiation at a tile short enough for the f32 bound to
    # sit orders of magnitude under the control's distance (the tile is a
    # runtime argument: this holds the dispatch the main path launched)
    sep = blocks[:T_SEP].contiguous()
    kw_sep = dict(kw, transfer_tile=TT_SEP)
    err_sep, _ = logprob_case(
        f"K3-LOGPROB vs plain (F={F_SOFT} T={T_SEP} TT={TT_SEP})",
        k3(sep, w, **kw_sep), transfer_matrix_ref(sep, w, **kw_sep),
        TT_SEP, m_scale, B, R, False,
        control=k3(sep, w, **dict(kw_sep, semiring="tropical")), separate=True)
    k3_err = max(k3_err, err_sep)
    # the register layout's cases, on half-scaled integer and AWGN LLRs
    for label, tbc, wc, tt_case, ints, noisy in k3_layout_inputs(llrs, gen):
        for kind, xin in (("integer", ints), ("AWGN", noisy)):
            xin = (xin * 0.5).contiguous()
            kwc = dict(n_states=tbc.n_states, n_slots=tbc.n_slots,
                       transfer_tile=tt_case, semiring="logprob")
            err_c, _ = logprob_case(
                f"K3-LOGPROB vs plain {label}, {kind} LLRs (F={xin.shape[1]} "
                f"T={xin.shape[0]} TT={tt_case})",
                k3(xin, wc, **kwc), transfer_matrix_ref(xin, wc, **kwc), tt_case,
                xin.abs().sum(dim=-1).max().item() + math.log(tbc.n_slots),
                tbc.llr_block, tbc.n_slots, False)
            k3_err = max(k3_err, err_c)
    # the rest of decode_soft in its stages, CUDA events
    lam0 = init_metric(F_SOFT, S, 0, device=dev)
    beta_end = init_metric(F_SOFT, S, None, device=dev)
    compose = tp._compose(prec.matmul_dtype, LOGPROB)
    flip = tp._compose(prec.matmul_dtype, LOGPROB, flip=True)
    prefix_ms = cuda_ms(lambda: tp.associative_scan(compose, m))
    entry = tp.entry_from_prefix(tp.associative_scan(compose, m), lam0, LOGPROB)
    suffix_ms = cuda_ms(lambda: tp.associative_scan(flip, m, reverse=True))
    suffix = tp.associative_scan(flip, m, reverse=True)
    beta_start = LOGPROB.sum(suffix + beta_end[None, :, None, :], dim=-1)
    del suffix
    beta_tile_end = torch.cat([beta_start[1:], beta_end[None]], dim=0)
    tiles = tp.tiled_blocks(blocks, tt).reshape(tt, N * F_SOFT, B)
    rev = build_reverse_tables(spec, 2)
    alpha_ms = cuda_ms(lambda: soft._alpha_scan(
        tiles, entry.reshape(N * F_SOFT, S), tables, prec))
    alphas = soft._alpha_scan(tiles, entry.reshape(N * F_SOFT, S), tables, prec)
    beta_ms = cuda_ms(lambda: soft._beta_scan(
        tiles, beta_tile_end.reshape(N * F_SOFT, S), rev, prec))
    alphas += soft._beta_scan(tiles, beta_tile_end.reshape(N * F_SOFT, S), rev, prec)
    joint = alphas.view(tt, N, F_SOFT, S).permute(1, 0, 2, 3).reshape(T, F_SOFT, S)
    del alphas
    llr_ms = cuda_ms(lambda: soft._llrs_from_joints(joint, tables))
    staged = soft._llrs_from_joints(joint, tables)
    if not torch.equal(staged, out):
        fail("decode_soft in stages gives other LLRs than the call (max |diff| "
             f"{(staged - out).abs().max().item()!r}): the stage times describe "
             "other code")
    print("decode_soft in stages: the same LLRs as the call")
    del joint, staged, m, entry, beta_start, beta_tile_end, tiles
    torch.cuda.reset_peak_memory_stats()
    walls = sorted(host_ms(lambda: decoder.decode_soft(x))[1] for _ in range(3))
    wall = walls[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"time K3-LOGPROB transfer_matrix: {k3_ms:.3f} ms (F={F_SOFT} x "
          f"T={T} steps, TT={tt})")
    print(f"time LOGPROB prefix scan (associative_scan): {prefix_ms:.3f} ms")
    print(f"time LOGPROB suffix scan (reverse associative_scan): {suffix_ms:.3f} ms")
    print(f"time alpha scan ({tt} steps x {N * F_SOFT} rows): {alpha_ms:.3f} ms")
    print(f"time beta scan ({tt - 1} steps x {N * F_SOFT} rows): {beta_ms:.3f} ms")
    print(f"time _llrs_from_joints ({T} x {F_SOFT} x {S}): {llr_ms:.3f} ms")
    print(f"time decode_soft(llr) wall: {wall:.3f} ms (median of "
          f"{', '.join(f'{t:.3f}' for t in walls)}; K3-LOGPROB {k3_ms / wall:.1%})")
    print(f"soft decoded: {F_SOFT * N_FULL / wall / 1e3:.3f} Mb/s")
    print(f"peak device memory over the decode_soft calls: {peak:.2f} GiB")
    print(f"time K3-LOGPROB plain version (transfer_matrix_ref): {k3_plain_ms:.3f} ms",
          flush=True)
    k3_bound, k3_bound_by = acs_bound(
        w, B, S, R, F_SOFT * T, S, False,
        blocks.numel() * 4 + w.numel() * 4 + N * F_SOFT * S * S * 4,
        extra_ops=N * F_SOFT * S * S * 2, semiring="logprob",
    )
    print(f"K3-LOGPROB bound: {k3_bound:.3f} ms ({k3_bound_by}); K3-LOGPROB at "
          f"{k3_bound / k3_ms:.2%} of it")

    # K1-LOGPROB: forward_fused(semiring=LOGPROB) on the same blocks
    k1.launches = k1.logprob_launches = 0
    lam_k, phi_k = forward_fused(blocks, lam0, tables, prec, semiring=LOGPROB)
    torch.cuda.synchronize()
    k1_launches = k1.logprob_launches
    print(f"forward_fused(semiring=LOGPROB): K1-LOGPROB launches {k1_launches} "
          f"(K1 launches in all {k1.launches})")
    if (k1_launches, k1.launches) != (1, 1):
        fail(f"forward_fused(LOGPROB) launched K1-LOGPROB {k1_launches} times")
    kw1 = dict(n_states=S, n_slots=R, semiring="logprob")
    k1l_ms = cuda_ms(lambda: k1(blocks, lam0, w, operands=ops_w, **kw1))
    k1l_plain_ms = cuda_ms(
        lambda: res.update(p=acs_forward_ref(blocks, lam0, w, **kw1)),
        warmup=lambda: acs_forward_ref(blocks[:16], lam0, w, **kw1))
    lam_p, phi_p = res.pop("p")
    d = -(-(spec.k - 1) // 2)  # steps in which every state reaches every state
    k1_scale = d * (2 * m_scale) + m_scale
    k1_err, _ = logprob_case(
        f"K1-LOGPROB vs plain metrics (F={F_SOFT} T={T})", lam_k, lam_p,
        T, k1_scale, B, R, True,
        control=k1(blocks, lam0, w, **dict(kw1, semiring="tropical"))[0])
    # the metrics' gate at a depth where the bound tells the semirings apart
    err_sep, _ = logprob_case(
        f"K1-LOGPROB vs plain metrics (F={F_SOFT} T={T1_SEP})",
        k1(blocks[:T1_SEP], lam0, w, **kw1)[0],
        acs_forward_ref(blocks[:T1_SEP], lam0, w, **kw1)[0],
        T1_SEP, k1_scale, B, R, True,
        control=k1(blocks[:T1_SEP], lam0, w, **dict(kw1, semiring="tropical"))[0],
        separate=True)
    k1_err = max(k1_err, err_sep)
    # survivors: a slot may differ only where the plain potentials' top two
    # are within PHI_TIE (the metrics differ by rounding)
    n_diff, gap = phi_tie_gap(phi_k, phi_p, blocks, lam0, w, tables, prec.renorm, False)
    print(f"K1-LOGPROB survivors: {n_diff} of {phi_p.numel()} differ from "
          f"the plain version's; largest top-two potential gap among them "
          f"{gap!r} (limit {PHI_TIE})")
    if not gap <= PHI_TIE:
        fail(f"K1-LOGPROB survivors differ at a potential gap of {gap}")
    k1l_lib_ms = cuda_ms(
        lambda: library_forward(blocks, lam0, w, S, R, semiring="logprob"),
        warmup=lambda: library_forward(blocks[:16], lam0, w, S, R, semiring="logprob"))
    print(f"time K1-LOGPROB acs_forward: {k1l_ms:.3f} ms (F={F_SOFT} x T={T} steps)")
    print(f"time K1-LOGPROB plain version (acs_forward_ref): {k1l_plain_ms:.3f} ms")
    print(f"time torch.matmul + torch.logsumexp yardstick: {k1l_lib_ms:.3f} ms")
    k1l_bound, k1l_bound_by = acs_bound(
        w, B, S, R, F_SOFT * T, 1, True,
        blocks.numel() * 4 + lam0.numel() * 4 + w.numel() * 4
        + phi_k.numel() * phi_k.element_size() + lam_k.numel() * 4,
        semiring="logprob",
    )
    print(f"K1-LOGPROB bound: {k1l_bound:.3f} ms ({k1l_bound_by}); K1-LOGPROB at "
          f"{k1l_bound / k1l_ms:.2%} of it", flush=True)
    del phi_k, phi_p, blocks

    # the list decode: 64 frames x N_LIST stages
    xl = x[:, :N_LIST].contiguous()
    (lbits, lmet), paths = dispatched(
        lambda: decoder.decode_soft(xl, output="list", n_list=L_LIST))
    if paths != {"soft_list": 1} or lbits.shape != (F_SOFT, L_LIST, N_LIST):
        fail(f"decode_soft(list) dispatched {paths}, returned {tuple(lbits.shape)}")
    for label, xin in (("AWGN", xl), ("integer", quant[:F_SOFT, :N_LIST])):
        one, _ = decoder.decode_soft(xin, output="list", n_list=1)
        hb = decoder.decode_batch(xin, time_parallel=False)
        if not torch.equal(one[:, 0], hb):
            fail(f"{label} LLRs: the L=1 list decode differs from "
                 f"decode_batch(time_parallel=False) in "
                 f"{int((one[:, 0] != hb).sum())} bits")
        print(f"{label} LLRs: list decode at n_list=1 == decode_batch("
              f"time_parallel=False), {F_SOFT} x {N_LIST} stages")
    rank0 = int((lbits[:, 0] != decoder.decode_batch(xl, time_parallel=False)).sum())
    print(f"list decode n_list={L_LIST}: rank-0 bits differ from decode_batch's "
          f"in {rank0} bits")
    _, list_wall = host_ms(lambda: decoder.decode_soft(xl, output="list",
                                                       n_list=L_LIST))
    blocks_l = blocks_from_llrs(xl, 2)
    lam0_l = soft.init_list_metric(init_metric(F_SOFT, S, 0, device=dev), L_LIST)
    lf_ms = cuda_ms(lambda: soft.list_forward(blocks_l, lam0_l, tables, prec, L_LIST))
    lam_l, phis_l = soft.list_forward(blocks_l, lam0_l, tables, prec, L_LIST)
    lt_ms = cuda_ms(lambda: soft.list_traceback(phis_l, lam_l, tables, L_LIST))
    del phis_l
    print(f"time list_forward ({N_LIST // 2} steps, n_list={L_LIST}): {lf_ms:.3f} ms")
    print(f"time list_traceback ({N_LIST // 2} steps): {lt_ms:.3f} ms")
    print(f"time decode_soft(list, n_list={L_LIST}) wall (one sample): "
          f"{list_wall:.3f} ms", flush=True)

    # lte-tbcc: tail-biting frames through the exact circular BCJR
    tbd = ViterbiDecoder.from_standard("lte-tbcc")
    spec3, tb3 = tbd.spec, tbd.tables
    k = spec3.k
    msg = torch.randint(0, 2, (F_TBCC, N_TBCC), generator=gen, device=dev)
    # tail-biting: the register starts with the frame's last k-1 bits
    coded = conv_encode_torch(torch.cat([msg[:, -(k - 1):], msg], dim=1), spec3)
    y = llr(awgn(gen, bpsk(coded[:, k - 1:]), EBN0_DB, spec3.rate),
            EBN0_DB, spec3.rate)
    for kernel in (k1, k3):
        kernel.launches = kernel.logprob_launches = 0
    out3, paths = dispatched(lambda: tbd.decode_soft(y))
    tb_launches = k3.logprob_launches
    print(f"lte-tbcc decode_soft: dispatch {paths}; K3-LOGPROB launches "
          f"{tb_launches} (K3 {k3.launches}, K1 {k1.launches})")
    if paths != {"soft": 1} or (tb_launches, k3.launches, k1.launches) != (1, 1, 0):
        fail(f"lte-tbcc decode_soft dispatched {paths} with {tb_launches} "
             "K3-LOGPROB launches")
    if out3.shape != (F_TBCC, N_TBCC) or not bool(torch.isfinite(out3).all()):
        fail(f"lte-tbcc decode_soft returned {tuple(out3.shape)} or non-finite LLRs")
    err3 = int(((out3 < 0).to(msg.dtype) != msg).sum())
    ber3 = err3 / msg.numel()
    print(f"lte-tbcc AWGN Eb/N0={EBN0_DB} dB: {err3} bit errors in {msg.numel()} "
          f"bits, BER {ber3:.3e} (limit {TBCC_BER_LIMIT:g})")
    if not ber3 <= TBCC_BER_LIMIT:
        fail(f"lte-tbcc BER {ber3:.3e} above {TBCC_BER_LIMIT:g}")
    blocks3 = (blocks_from_llrs(y, 2) * 0.5).contiguous()
    w3 = torch.as_tensor(tb3.fused_w, device=dev)
    kw3 = dict(n_states=S, n_slots=R, transfer_tile=1, semiring="logprob")
    ops_w3 = viterbi_acs.gather_operands(w3, tb3.llr_block, S, R)
    k3_tb_ms = cuda_ms(lambda: k3(blocks3, w3, operands=ops_w3, **kw3), reps=5)
    a = k3(blocks3, w3, **kw3)
    k3_tb_plain_ms = cuda_ms(lambda: res.update(a=transfer_matrix_ref(blocks3, w3, **kw3)))
    err_tb, _ = logprob_case(
        f"K3-LOGPROB vs plain, lte-tbcc (F={F_TBCC} T={N_TBCC // 2} TT=1, "
        f"B={tb3.llr_block})", a, res.pop("a"), 1,
        blocks3.abs().sum(dim=-1).max().item() + math.log(R), tb3.llr_block, R,
        False, control=k3(blocks3, w3, **dict(kw3, semiring="tropical")))
    walls3 = sorted(host_ms(lambda: tbd.decode_soft(y))[1] for _ in range(3))
    print(f"time K3-LOGPROB at TT=1 (lte-tbcc, {F_TBCC} x {N_TBCC // 2} steps): "
          f"{k3_tb_ms:.3f} ms; plain version {k3_tb_plain_ms:.3f} ms")
    print(f"time lte-tbcc decode_soft wall: {walls3[1]:.3f} ms (median of "
          f"{', '.join(f'{t:.3f}' for t in walls3)})")
    print(f"phase 10 (soft) took {time.perf_counter() - t_phase:.1f} s", flush=True)

    shape = (f"decode_soft(llr): F={F_SOFT} x {N_FULL} stages, T={T} steps, "
             f"TT={tt}, N={N}")
    return [{
        "name": "K1-LOGPROB acs_forward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acs_forward.cu",
        "replaces": "src/repro/kernels/viterbi_acs.py:172",
        "launches": k1_launches,
        "max_abs_err": max(k1_err, sweep_err),
        "ms": k1l_ms,
        "shape": f"forward_fused(semiring=LOGPROB): F={F_SOFT} x T={T} steps",
        "plain_ms": k1l_plain_ms,
        "bound_ms": k1l_bound,
        "bound_by": k1l_bound_by,
        "library_ms": k1l_lib_ms,
    }, {
        "name": "K3-LOGPROB transfer_matrix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/transfer_matrix.cu",
        "replaces": "src/repro/kernels/viterbi_acs.py:624",
        "launches": k3_launches,
        "max_abs_err": max(k3_err, err_tb),
        "ms": k3_ms,
        "shape": shape,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound,
        "bound_by": k3_bound_by,
        "library_ms": None,
    }]


# -- phase 11: the standard codes -------------------------------------------

def codes_cell(name, n_frames, n_msg, ebn0_db, dev, seed=SEED):
    """(message bits (F, n_msg) int32, AWGN LLRs, their integer copy) of
    one cell of a registry code, drawn on the card:
    ``simulate.sim_frame_batch``'s tx chain (tail, encode, puncture,
    BPSK + AWGN at the effective rate) on a generator seeded with
    ``point_key(seed, name, ebn0_db)``.  Punctured codes give the serial
    kept stream (F, Lp)."""
    from repro_torch.codes import get_code
    from repro_torch.codes.simulate import point_key, sim_frame_batch

    gen = torch.Generator(device=dev).manual_seed(point_key(seed, name, ebn0_db))
    bits, llrs = sim_frame_batch(gen, get_code(name), n_frames, n_msg, ebn0_db)
    return bits, llrs, torch.clamp(torch.round(llrs), -16, 16)


class Stages:
    """Record CUDA events around the kernel wrappers and the tracebacks a
    decode calls, with the launch counts each call adds: the stages of
    one run, read without a second run.  ``patches`` maps a label to
    (module, attribute); the calls of the labels in ``keep`` are kept in
    ``kept`` as (label, arguments, keywords, output).  ``log`` is in the
    order the calls return, so a call's inner calls come before it."""

    def __init__(self, patches, keep=()):
        from repro_torch.kernels import viterbi_acs

        self.patches, self.keep = patches, keep
        self.log, self.kept, self.saved = [], [], {}
        self.counters = (viterbi_acs.acs_forward, viterbi_acs.acs_decode_fused,
                         viterbi_acs.transfer_matrix)

    def __enter__(self):
        for label, (mod, attr) in self.patches.items():
            fn = getattr(mod, attr)
            self.saved[label] = fn
            setattr(mod, attr, self._wrap(label, fn))
        return self

    def __exit__(self, *exc):
        for label, (mod, attr) in self.patches.items():
            setattr(mod, attr, self.saved[label])

    def _wrap(self, label, fn):
        def timed(*args, **kw):
            before = [c.launches for c in self.counters]
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            self.log.append((label, start, stop, [c.launches - b for c, b in
                                                  zip(self.counters, before)]))
            if label in self.keep:
                self.kept.append((label, args, kw, out))
            return out
        return timed

    def ms(self, label):
        """Summed event time of the calls labelled ``label``, after a
        synchronize."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for lab, s, e, _ in self.log if lab == label)

    def count(self, label):
        return sum(lab == label for lab, *_ in self.log)


def kernel_patches(**extra):
    """Stages' patches: the kernel wrappers where ``kernels/ops.py`` calls
    them, and ``extra`` (label=(module, attribute))."""
    from repro_torch.kernels import ops

    return {"K1": (ops, "acs_forward"), "K2": (ops, "acs_decode_fused"),
            "K3": (ops, "transfer_matrix"), **extra}


def launch_counts():
    from repro_torch.kernels import viterbi_acs

    k1, k2, k3 = (viterbi_acs.acs_forward, viterbi_acs.acs_decode_fused,
                  viterbi_acs.transfer_matrix)
    return {"K1": k1.launches - k1.logprob_launches, "K1-LOGPROB": k1.logprob_launches,
            "K2": k2.launches, "K3": k3.launches - k3.logprob_launches,
            "K3-LOGPROB": k3.logprob_launches}


def zero_counts():
    from repro_torch.kernels import viterbi_acs

    for kernel in (viterbi_acs.acs_forward, viterbi_acs.transfer_matrix):
        kernel.launches = kernel.logprob_launches = 0
    viterbi_acs.acs_decode_fused.launches = 0


def main_path(label, fn, want_paths, want_launches, patches=None, keep=()):
    """Drive one path of phase 11: counts zeroed just before, read just
    after; fails unless the dispatches and launches are ``want_*``.
    Returns (result, the launches read, its wall in ms (host clock), the
    run's Stages, which keeps the calls of the kernels in ``keep``)."""
    stages = Stages(patches or kernel_patches(), keep)
    zero_counts()
    with stages:
        (out, wall), paths = dispatched(lambda: host_ms(fn))
    got = {k: v for k, v in launch_counts().items() if v}
    print(f"{label}: dispatch {paths}; launches {got}", flush=True)
    if paths != want_paths:
        fail(f"{label} dispatched {paths}, not {want_paths}")
    if got != want_launches:
        fail(f"{label} launched {got}, not {want_launches}")
    return out, got, wall, stages


def kept_run(fn, keep):
    """(result, Stages) of ``fn``, the calls of the kernels in ``keep``
    kept."""
    with Stages(kernel_patches(), keep) as stages:
        out = fn()
    return out, stages


def hold_kept(label, stages, pick=None):
    """Hold the kernel calls a run kept bit for bit to their plain
    versions (``kernels/ref.py``) on the same tensors on the card: the
    shapes, entry metrics and ring layouts that the path gave each
    kernel.  ``pick`` chooses calls by index (default: all)."""
    from repro_torch.kernels import ref

    plain = {"K1": ref.acs_forward_ref, "K2": ref.acs_decode_fused_ref,
             "K3": ref.transfer_matrix_ref}
    calls = stages.kept if pick is None else [stages.kept[i] for i in pick]
    for kernel, args, kw, out in calls:
        want = plain[kernel](*args, **{k: v for k, v in kw.items() if k != "operands"})
        got = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want) or not all(torch.equal(g, p) for g, p in zip(got, want)):
            fail(f"{label}: {kernel} differs from its plain version at blocks "
                 f"{tuple(args[0].shape)}")
    shapes = ", ".join(f"{k} {tuple(a[0].shape)}" for k, a, _, _ in calls)
    print(f"{label}: {len(calls)} kernel calls of the path bit-identical to their "
          f"plain versions (blocks T x F x B: {shapes})", flush=True)


def hold_logprob_k3(label, call):
    """K3-LOGPROB as a path called it, against its plain version on the
    same tensors: within ``logprob_bound`` at the path's tile (the
    tropical instantiation's distance printed), and at tiles of
    ``TT_SEP`` steps over the first ``T_SEP`` steps of the same blocks,
    where the gate must reject the tropical instantiation.  Returns the
    larger error."""
    import math

    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import transfer_matrix_ref

    _, (blocks, w), kw, got = call
    kw = {k: v for k, v in kw.items() if k != "operands"}
    tt, R, (T, F, B) = kw["transfer_tile"], kw["n_slots"], blocks.shape
    scale = blocks.abs().sum(dim=-1).max().item() + math.log(R)
    err, _ = logprob_case(
        f"{label}: K3-LOGPROB vs plain (F={F} T={T} TT={tt})", got,
        transfer_matrix_ref(blocks, w, **kw), tt, scale, B, R, False,
        control=viterbi_acs.transfer_matrix(blocks, w, **dict(kw, semiring="tropical")))
    sep, kw_sep = blocks[:T_SEP].contiguous(), dict(kw, transfer_tile=TT_SEP)
    err_sep, _ = logprob_case(
        f"{label}: K3-LOGPROB vs plain (F={F} T={T_SEP} TT={TT_SEP})",
        viterbi_acs.transfer_matrix(sep, w, **kw_sep),
        transfer_matrix_ref(sep, w, **kw_sep), TT_SEP, scale, B, R, False,
        control=viterbi_acs.transfer_matrix(sep, w, **dict(kw_sep, semiring="tropical")),
        separate=True)
    return max(err, err_sep)


def gate_ber(label, decoded, bits, limit):
    """Bit errors of ``decoded`` (message columns first) against ``bits``;
    fails above ``limit``."""
    errors = int((decoded[:, :bits.shape[1]] != bits).sum())
    ber = errors / bits.numel()
    print(f"{label}: {errors} bit errors in {bits.numel()} bits, BER {ber:.3e} "
          f"(limit {limit:g})", flush=True)
    if not ber <= limit:
        fail(f"{label}: BER {ber:.3e} above {limit:g}")


def gate_equal(label, got, want):
    if got.shape != want.shape or not torch.equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else "shape"
        fail(f"{label}: bits differ ({n})")
    print(f"{label}: equal", flush=True)


def timed_walls(fn, patches):
    """Three walls of ``fn`` (host clock, synchronized) after the warm-up
    its main run gave, each call under Stages: (median wall, "median of
    ..." text, the median call's Stages, whose CUDA events the timing
    lines print)."""
    runs = []
    for _ in range(3):
        with Stages(patches) as st:
            _, ms = host_ms(fn)
        runs.append((ms, st))
    runs.sort(key=lambda r: r[0])
    text = f"median of {', '.join(f'{ms:.3f}' for ms, _ in runs)}"
    return runs[1][0], text, runs[1][1]


def mbps(n_bits, ms):
    return f"{n_bits / ms / 1e3:.3f} Mb/s"


def punctured_batch(name, n_msg, ebn0, dev, launches):
    """One 512-frame punctured cell through ``decode_batch`` (one K1 and
    the plain traceback): BER, K1 held to its plain version on the
    integer-LLR run, walls.  Returns (decoder, message bits, AWGN LLRs,
    AWGN bits, integer LLRs, integer bits)."""
    from repro_torch.core import ViterbiDecoder
    from repro_torch.core import viterbi as viterbi_mod

    bits, llrs, quant = codes_cell(name, F_CODES, n_msg, ebn0, dev)
    dec = ViterbiDecoder.from_standard(name, device=dev)
    n_stages = dec.puncture.stages_for(llrs.shape[1])
    print(f"{name}: {F_CODES} frames x {llrs.shape[1]} kept LLRs = {n_stages} "
          f"stages ({n_msg} message bits), Eb/N0 {ebn0} dB; decision depth "
          f"{dec.decision_depth} stages, tiled overlap "
          f"{dec.default_tiled_config().overlap}", flush=True)
    label = f"{name} decode_batch"
    out, launches[label], _, _ = main_path(
        label, lambda: dec.decode_batch(llrs), {"batch": 1}, {"K1": 1})
    gate_ber(f"{label} AWGN", out, bits, BER_LIMIT)
    out_q, st = kept_run(lambda: dec.decode_batch(quant), ("K1",))
    hold_kept(f"{label} (integer LLRs)", st)
    del st
    wall, text, st = timed_walls(lambda: dec.decode_batch(llrs),
                                 kernel_patches(traceback=(viterbi_mod, "traceback")))
    steps, tb = n_stages // dec.rho, st.ms("traceback")
    print(f"time {label}: K1 {st.ms('K1'):.3f} ms, traceback {tb:.3f} ms "
          f"({tb / steps * 1e3:.1f} us a step over {steps} steps) (CUDA events, "
          f"the median call); wall {wall:.3f} ms ({text}); decoded "
          f"{mbps(F_CODES * n_msg, wall)}", flush=True)
    return dec, bits, llrs, out, quant, out_q


def chunked_stream(name, dec, n_msg, llrs, out, quant, out_q, launches):
    """The same cell through ``decode_stream_chunked``: each chunk's path,
    launches and CUDA-event times from the main run, whose wall is the
    one timed sample; bits == batch bits on the AWGN and the integer
    LLRs; K1 at chunks 1, 2 and the last held to its plain version on
    the integer-LLR run."""
    from repro_torch.core import decoder as decoder_mod

    n_chunks = -(-dec.puncture.stages_for(llrs.shape[1]) // CHUNK_LEN)
    patches = kernel_patches(traceback=(decoder_mod, "traceback"),
                             two_pass=(decoder_mod, "_chunk_step"),
                             one_pass=(decoder_mod, "_chunk_step_fused"))
    label = f"{name} decode_stream_chunked"
    outs, launches[label], wall, st = main_path(
        label, lambda: dec.decode_stream_chunked(llrs, chunk_len=CHUNK_LEN,
                                                 initial_state=0),
        {"chunk_two_pass": n_chunks}, {"K1": n_chunks}, patches)
    torch.cuda.synchronize()
    chunk, inner = 0, {"K1": 0.0, "K2": 0.0, "K3": 0.0, "traceback": 0.0}
    for lab, s, e, (k1_n, k2_n, _) in st.log:
        ms = s.elapsed_time(e)
        if lab in inner:
            inner[lab] += ms
            continue
        chunk += 1
        print(f"  chunk {chunk}: {lab}, K1 launches {k1_n}, K2 launches {k2_n}; "
              f"K1 {inner['K1']:.3f} ms, K2 {inner['K2']:.3f} ms, traceback "
              f"{inner['traceback']:.3f} ms (CUDA events)")
        inner = dict.fromkeys(inner, 0.0)
    print(f"  flush: traceback {inner['traceback']:.3f} ms (CUDA events)")
    print(f"time {label}: {n_chunks} chunks of {CHUNK_LEN} stages, K1 "
          f"{st.ms('K1'):.3f} ms, tracebacks {st.ms('traceback'):.3f} ms (CUDA "
          f"events, summed); wall {wall:.3f} ms (the gated call itself, one "
          f"sample); decoded {mbps(F_CODES * n_msg, wall)}", flush=True)
    del st
    gate_equal(f"{name} chunked bits == batch bits (AWGN LLRs)", outs, out)
    outs_q, st = kept_run(lambda: dec.decode_stream_chunked(
        quant, chunk_len=CHUNK_LEN, initial_state=0), ("K1",))
    gate_equal(f"{name} chunked bits == batch bits (integer LLRs)", outs_q, out_q)
    hold_kept(f"{name} two-pass chunks 1, 2 and {n_chunks} (integer LLRs)", st,
              pick=(0, 1, n_chunks - 1))


def tiled_stream(name, dev, launches):
    """One 2^20-LLR stream of ``name`` through ``decode_stream_tiled`` (one
    K2) and through ``decode_batch(time_parallel=True)`` (one K3, one
    K1): the two give the same bits; each kernel held to its plain
    version on the integer-LLR runs; walls."""
    from repro_torch.codes import get_code
    from repro_torch.core import ViterbiDecoder
    from repro_torch.core import timeparallel as tp_mod

    code = get_code(name)
    n_bits = code.puncture.stages_for(N_TILED_CODES) - (code.spec.k - 1)
    bits, llrs, quant = codes_cell(name, 1, n_bits, EBN0_CODES, dev, seed=SEED + 1)
    stream, stream_q = llrs[0], quant[0]
    dec = ViterbiDecoder.from_standard(name, device=dev)
    label = f"{name} decode_stream_tiled"
    tiled, launches[label], _, st = main_path(
        f"{label} ({N_TILED_CODES} kept LLRs)", lambda: dec.decode_stream_tiled(stream),
        {"tiled": 1}, {"K2": 1}, keep=("K2",))
    cfg = dec.default_tiled_config()
    print(f"{name} tiled: windows of {cfg.window} stages (overlap {cfg.overlap}), "
          f"K2 at tile {st.kept[0][2]['time_tile']}")
    del st
    gate_ber(f"{label} AWGN", tiled[None], bits, BER_LIMIT)
    _, st = kept_run(lambda: dec.decode_stream_tiled(stream_q), ("K2",))
    hold_kept(f"{label} (integer LLRs)", st)
    del st
    wall, text, st = timed_walls(lambda: dec.decode_stream_tiled(stream), kernel_patches())
    print(f"time {label}: K2 {st.ms('K2'):.3f} ms (CUDA events, the median call); "
          f"wall {wall:.3f} ms ({text}); decoded {mbps(n_bits, wall)}", flush=True)

    label = f"{name} decode_batch(time_parallel=True)"
    batch, launches[label], _, _ = main_path(
        f"{label} on the tiled stream", lambda: dec.decode_batch(
            stream[None], time_parallel=True), {"time_parallel": 1}, {"K3": 1, "K1": 1})
    gate_equal(f"{name} tiled bits == time-parallel batch bits (AWGN LLRs)",
               tiled, batch[0])
    _, st = kept_run(lambda: dec.decode_batch(stream_q[None], time_parallel=True),
                     ("K1", "K3"))
    hold_kept(f"{label} (integer LLRs)", st)
    del st
    wall, text, st = timed_walls(
        lambda: dec.decode_batch(stream[None], time_parallel=True),
        kernel_patches(traceback=(tp_mod, "traceback")))
    print(f"time {label}: K3 {st.ms('K3'):.3f} ms, recovery K1 {st.ms('K1'):.3f} ms, "
          f"traceback {st.ms('traceback'):.3f} ms (CUDA events, the median call); "
          f"wall {wall:.3f} ms ({text}); decoded {mbps(n_bits, wall)}", flush=True)


def tailbiting_blocks(dev, launches):
    """decode_tbcc_blocks: 8192 x 128 lte-tbcc blocks through
    ``decode_batch`` and ``decode_tailbiting`` (WAVA, one K1 a
    circulation), then the first 64 with ``time_parallel=True,
    transfer_tile=8`` (one K3, one K1 a circulation), which must equal
    sequential WAVA, bits and converged flags; every kernel call held to
    its plain version on the integer-LLR runs; walls."""
    from repro_torch.codes import tailbiting as tb_mod
    from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS
    from repro_torch.core import ViterbiDecoder

    name, n = "lte-tbcc", DEFAULT_WAVA_ITERS
    bits, x, xq = codes_cell(name, F_TBCC_CELL, N_TBCC_CELL, EBN0_CODES, dev)
    dec = ViterbiDecoder.from_standard(name, device=dev)
    label = f"{name} decode_batch"
    out, launches[label], _, _ = main_path(
        f"{label} ({F_TBCC_CELL} x {N_TBCC_CELL} bits)", lambda: dec.decode_batch(x),
        {"wava": 1}, {"K1": n})
    gate_ber(f"{label} AWGN", out, bits, TBCC_BER_LIMIT)
    label = f"{name} decode_tailbiting"
    (wb, wc), launches[label], _, _ = main_path(
        label, lambda: dec.decode_tailbiting(x), {"wava": 1}, {"K1": n})
    print(f"{name}: converged share {wc.float().mean().item():.6f}")
    gate_equal(f"{name} decode_tailbiting bits == decode_batch bits", wb, out)
    _, st = kept_run(lambda: dec.decode_tailbiting(xq), ("K1",))
    hold_kept(f"{name} WAVA's circulations (integer LLRs)", st)
    del st
    patches = kernel_patches(traceback=(tb_mod, "traceback_with_state"))
    wall, text, st = timed_walls(lambda: dec.decode_batch(x), patches)
    print(f"time {name} decode_batch (WAVA): K1 {st.ms('K1'):.3f} ms over "
          f"{st.count('K1')} circulations, tracebacks {st.ms('traceback'):.3f} ms "
          f"(CUDA events, the median call); wall {wall:.3f} ms ({text}); decoded "
          f"{mbps(bits.numel(), wall)}", flush=True)

    tp_dec = ViterbiDecoder.from_standard(name, time_parallel=True,
                                          transfer_tile=TT_TBCC_TP, device=dev)
    xt = x[:F_TBCC_TP]
    label = f"{name} time-parallel WAVA"
    (tb, tc), launches[label], _, _ = main_path(
        f"{name} decode_tailbiting(time_parallel=True, transfer_tile={TT_TBCC_TP}) "
        f"on {F_TBCC_TP} blocks", lambda: tp_dec.decode_tailbiting(xt),
        {"wava": 1}, {"K1": n, "K3": 1})
    gate_equal(f"{label} bits == sequential WAVA's", tb, wb[:F_TBCC_TP])
    gate_equal(f"{label} converged flags == sequential WAVA's", tc, wc[:F_TBCC_TP])
    _, st = kept_run(lambda: tp_dec.decode_tailbiting(xq[:F_TBCC_TP]), ("K1", "K3"))
    hold_kept(f"{label}, K3 and the recoveries (integer LLRs)", st)
    del st
    wall, text, st = timed_walls(lambda: tp_dec.decode_tailbiting(xt), patches)
    print(f"time {label} ({F_TBCC_TP} blocks, transfer_tile={TT_TBCC_TP}): K3 "
          f"{st.ms('K3'):.3f} ms, K1 {st.ms('K1'):.3f} ms over {st.count('K1')} "
          f"recoveries, tracebacks {st.ms('traceback'):.3f} ms (CUDA events, the "
          f"median call); wall {wall:.3f} ms ({text}); decoded "
          f"{mbps(F_TBCC_TP * N_TBCC_CELL, wall)}", flush=True)


def punctured_soft(name, dec, bits, llrs, hard, launches):
    """``decode_soft(output="llr")`` on the first ``F_SOFT`` frames of a
    punctured cell (one K3-LOGPROB): BER of ``llr < 0``, K3-LOGPROB held
    to its plain version within ``logprob_bound``; walls.  Returns
    K3-LOGPROB's largest error."""
    xs, bits = llrs[:F_SOFT], bits[:F_SOFT]
    label = f"{name} decode_soft"
    soft, launches[label], _, st = main_path(
        f"{label}(llr) on {F_SOFT} frames", lambda: dec.decode_soft(xs),
        {"soft": 1}, {"K3-LOGPROB": 1}, keep=("K3",))
    signs = (soft < 0).to(torch.int32)
    print(f"{name} soft: {int((signs != hard[:F_SOFT]).sum())} bits of llr < 0 "
          f"differ from decode_batch's; min |llr| {soft.abs().min().item():.3f}")
    gate_ber(f"{label} llr < 0", signs, bits, BER_LIMIT)
    err = hold_logprob_k3(label, st.kept[0])
    del st, soft
    wall, text, st = timed_walls(lambda: dec.decode_soft(xs), kernel_patches())
    print(f"time {label}(llr) on {F_SOFT} frames: K3-LOGPROB {st.ms('K3'):.3f} ms "
          f"(CUDA events, the median call); wall {wall:.3f} ms ({text}); decoded "
          f"{mbps(bits.numel(), wall)}", flush=True)
    return err


def codes_phase(dev):
    """Phase 11: the standard codes on the reference's cells, through the
    kernels, all on the card.  Returns ({path: {kernel: launches}} of the
    main-path runs, K3-LOGPROB's largest error against its plain
    version)."""
    from repro_torch.codes import smoke
    from repro_torch.core import soft_smoke

    t_phase = time.perf_counter()
    launches = {}
    wifi = "wifi-11a-r34"
    dec, bits, llrs, out, quant, out_q = punctured_batch(
        wifi, N_MSG_WIFI, EBN0_CODES, dev, launches)
    chunked_stream(wifi, dec, N_MSG_WIFI, llrs, out, quant, out_q, launches)
    del quant, out_q
    k3_logprob_err = punctured_soft(wifi, dec, bits, llrs, out, launches)
    del dec, bits, llrs, out
    tiled_stream(wifi, dev, launches)
    tailbiting_blocks(dev, launches)
    punctured_batch("dvb-s-r78", N_MSG_DVB, EBN0_DVB, dev, launches)
    smoke.main(device=dev)
    soft_smoke.main(device=dev)
    print(f"phase 11 (codes) took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {CODES_BUDGET_S} s)", flush=True)
    return launches, {"K3-LOGPROB": k3_logprob_err}


# -- phase 12: the serving engine ---------------------------------------------

# (code, SLO class, length, flushed, requests): the length is stages, or
# kept LLRs for a punctured code; flushed frames carry their zero tail
SERVE_BATCH = tuple(("ccsds-k7", "throughput", n, fl, 32)
                    for n in (1000, 3000, 6000, 8192) for fl in (False, True))
SERVE_OTHER = (
    ("ccsds-k7", "throughput", 12000, False, 32),
    ("ccsds-k7", "throughput", 16384, False, 32),
    ("ccsds-k7", "latency", 2000, False, 32),
    ("ccsds-k7", "latency", 4096, False, 32),
    ("wifi-11a-r34", "throughput", 3000, False, 32),
    ("wifi-11a-r34", "throughput", 8192, False, 32),
    ("lte-tbcc", "latency", 40, False, 512),
    ("ccsds-k7", "soft", 4096, False, 16),
)
SERVE_TENANTS, SERVE_CHUNKS, SERVE_CHUNK = 8, 4, 4096  # sessions: ccsds-k7 stages
STREAM_CHUNK = 4096  # decode_stream_chunked's default chunk, the stream route's
SERVE_CAPACITY, SERVE_MAX_BATCH = 6, 64
SERVE_EBN0 = 5.5
SERVE_BUDGET_S = 60  # phase 12's time budget, printed beside its seconds
SERVE_SOFT_ATOL = 1e-4  # the parity contract's LOGPROB tolerance


def serve_traffic(dev):
    """Phase 12's requests, drawn on the card (``sim_frame_batch`` on a
    generator seeded with ``point_key``): per group (message bits, AWGN
    LLRs, their integer copy, all (count, n, beta) or (count, Lp) on the
    card); and the sessions' streams, (tenants, chunks x SERVE_CHUNK, 2)."""
    from repro_torch.codes import get_code
    from repro_torch.codes.simulate import point_key, sim_frame_batch

    groups = []
    for gi, (name, slo, length, flushed, count) in enumerate(SERVE_BATCH + SERVE_OTHER):
        code = get_code(name)
        stages = code.puncture.stages_for(length) if code.puncture else length
        if code.puncture and code.puncture.punctured_len(stages) != length:
            fail(f"{name}: {length} kept LLRs are not whole stages")
        n_bits = stages if code.termination == "tailbiting" else stages - (code.spec.k - 1)
        gen = torch.Generator(device=dev).manual_seed(
            point_key(SEED + gi, name, SERVE_EBN0))
        bits, llrs = sim_frame_batch(gen, code, count, n_bits, SERVE_EBN0)
        groups.append(dict(code=name, slo=slo, length=length, flushed=flushed,
                           bits=bits, llrs=llrs, quant=torch.clamp(torch.round(llrs), -16, 16)))
    gen = torch.Generator(device=dev).manual_seed(
        point_key(SEED + len(groups), "ccsds-k7", SERVE_EBN0))
    _, streams = sim_frame_batch(gen, get_code("ccsds-k7"), SERVE_TENANTS,
                                 SERVE_CHUNKS * SERVE_CHUNK - 6, SERVE_EBN0)
    return groups, streams


class RouteLog:
    """Per dispatch of an engine: (code, route, frames, length, shards of
    the mesh, {kernel: launches}), read from the launch counters around
    ``_dispatch_with_faults`` and ``_dispatch_session_group`` (the route
    is the one the dispatch ended on)."""

    def __init__(self, engine):
        self.rows = []
        batch, session = engine._dispatch_with_faults, engine._dispatch_session_group

        def logged_batch(code, fn, path, f, l, *rest):
            before, mesh = launch_counts(), engine.mesh
            out = batch(code, fn, path, f, l, *rest)
            self._add(before, code, out[0], f, l, 0 if mesh is None else mesh.size)
            return out

        def logged_session(code, c, sessions, *rest, **kw):
            before = launch_counts()
            out = session(code, c, sessions, *rest, **kw)
            self._add(before, code, "session", len(sessions), c, 0)
            return out

        engine._dispatch_with_faults = logged_batch
        engine._dispatch_session_group = logged_session

    def _add(self, before, *key):
        after = launch_counts()
        self.rows.append((*key, {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}))

    def per_route(self):
        """{route: {kernel: launches}} summed over the dispatches."""
        out = {}
        for _code, path, _f, _l, _sh, got in self.rows:
            acc = out.setdefault(path, {})
            for k, v in got.items():
                acc[k] = acc.get(k, 0) + v
        return out


def serve_want(path, length, shards):
    """The launches one dispatch of ``path`` makes: the routing table's
    kernels, K1 once a shard, K2 once a chunk of the stream, K1 once a
    WAVA circulation."""
    from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS

    return {"batch": {"K1": 1}, "sharded": {"K1": shards},
            "time_parallel": {"K3": 1, "K1": 1},
            "stream": {"K2": -(-length // STREAM_CHUNK)},
            "wava": {"K1": DEFAULT_WAVA_ITERS}, "soft": {"K3-LOGPROB": 1},
            "session": {"K2": 1}}[path]


def hold_k2_tiles(label, call):
    """Hold a K2 call a path made on its first, middle and last time
    tiles.  A later tile starts from K2's own metrics and ring after the
    steps before it (one launch on them from the call's entry state); on
    each tile K2 and its plain version must agree bit for bit (bits,
    metrics, exit ring), their bits must be the path's own rows of that
    tile, and after the last tile the metrics and exit ring must be the
    ones the path's call returned.  Returns the tiles held."""
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import acs_decode_fused_ref

    _, (blocks, lam0, hist0, w), kw, (bits, lam, hist) = call
    plain_kw = {k: v for k, v in kw.items() if k != "operands"}
    T = blocks.shape[0]
    tt = min(kw["time_tile"], T)
    rows = tt * kw["rho"]
    n = T // tt
    held = sorted({0, n // 2, n - 1})
    for j in held:
        lam_j, hist_j = lam0, hist0
        if j:
            _, lam_j, hist_j = viterbi_acs.acs_decode_fused(
                blocks[:j * tt].contiguous(), lam0, hist0, w, **kw)
        tile = blocks[j * tt:(j + 1) * tt].contiguous()
        got = viterbi_acs.acs_decode_fused(tile, lam_j, hist_j, w, **kw)
        want = acs_decode_fused_ref(tile, lam_j, hist_j, w, **plain_kw)
        if not all(torch.equal(g, p) for g, p in zip(got, want)):
            fail(f"{label}: K2 differs from its plain version on tile {j} of {n}")
        if not torch.equal(bits[j * rows:(j + 1) * rows], got[0]):
            fail(f"{label}: the path's K2 bits differ from a launch on tile {j} of {n}")
        if j == n - 1 and not (torch.equal(got[1], lam) and torch.equal(got[2], hist)):
            fail(f"{label}: the path's exit metrics or ring differ from the last tile's")
    print(f"{label}: K2 (blocks {tuple(blocks.shape)}, D={hist0.shape[0]}, TT={tt}) "
          f"on tiles {held} of {n} bit-identical to its plain version and to the "
          f"path's own bits, exit metrics and ring", flush=True)
    return len(held)


def serve_engine(dev, **kw):
    from repro_torch.serve import make_decode_engine

    return make_decode_engine(device=dev, max_batch=SERVE_MAX_BATCH,
                              session_capacity=SERVE_CAPACITY, **kw)


def serve_submit(engine, groups, key, now):
    """Submit every request of ``groups`` (its ``key`` LLRs: "llrs" or
    "quant") in group order; returns the tickets, per group, and the
    submit times (host clock)."""
    from repro_torch.serve import DecodeRequest

    tickets, t_sub = [], []
    for g in groups:
        host = g[key].cpu().numpy()
        row = []
        for x in host:
            t_sub.append(time.perf_counter())
            row.append(engine.submit(DecodeRequest(
                llrs=x, code=g["code"], slo=g["slo"], flushed=g["flushed"]), now=now))
        tickets.append(row)
    return tickets, t_sub


def serve_sessions(engine, streams, now):
    """Phase 12's tenants: t0..t5 open; four rounds, each a chunk of
    SERVE_CHUNK stages from every open tenant with chunks left, then a
    poll; after round 2, t6 and t7 open and evict the least recently
    used two (t0, t1); then every tenant closes.  Returns {sid: (its bits
    in order, tail included), consumed stages}."""
    host = streams.cpu().numpy()
    sids = [f"t{i}" for i in range(SERVE_TENANTS)]
    emitted, fed = {}, {}
    for sid in sids[:SERVE_CAPACITY]:
        engine.open_session("ccsds-k7", sid=sid, now=now)
    tails = {}
    for r in range(SERVE_CHUNKS):
        for sid in list(engine._sessions):
            i, k = int(sid[1:]), fed.get(sid, 0)
            if k < SERVE_CHUNKS:
                emitted.setdefault(sid, []).append(engine.submit_chunk(
                    sid, host[i, k * SERVE_CHUNK:(k + 1) * SERVE_CHUNK], now=now))
                fed[sid] = k + 1
        engine.poll(now=now)
        if r == 1:
            for sid in sids[SERVE_CAPACITY:]:
                engine.open_session("ccsds-k7", sid=sid, now=now)
            for sid in sids[:SERVE_TENANTS - SERVE_CAPACITY]:
                tails[sid] = engine.evicted_tail(sid)
    for sid in list(engine._sessions):
        tails[sid] = engine.close_session(sid, now=now)
    engine.drain(now=now)
    if engine.stats()["sessions_evicted"] != SERVE_TENANTS - SERVE_CAPACITY:
        fail(f"sessions: {engine.stats()['sessions_evicted']} evictions, not "
             f"{SERVE_TENANTS - SERVE_CAPACITY}")
    out = {}
    for sid in sids:
        if any(t.error or not t.done for t in emitted[sid]):
            fail(f"session {sid}: a chunk ticket failed or never completed")
        out[sid] = (np.concatenate([t.bits for t in emitted[sid]] + [tails[sid]]),
                    fed[sid] * SERVE_CHUNK)
    return out


def serve_direct(label, engine, groups, tickets, mesh=None):
    """Hold every ticket to a direct call, on the card, of the entry point
    its route names (``DecodeEngine._decode_fn``), with the same
    arguments, on the unpadded frames, one call a request group."""
    for g, row in zip(groups, tickets):
        paths = {t.path for t in row}
        if len(paths) != 1 or any(t.error or not t.done for t in row):
            fail(f"{label}: {g['code']} {g['slo']} {g['length']}: routes {paths}, "
                 f"errors {sorted({str(t.error) for t in row})}")
        path = paths.pop()
        dec, x = engine._decoder(g["code"]), g["llrs"]
        fin = 0 if g["flushed"] else None
        if path == "batch":
            want = dec.decode_batch(x, initial_state=0, final_state=fin, time_parallel=False)
        elif path == "time_parallel":
            want = dec.decode_batch(x, initial_state=0, final_state=fin, time_parallel=True)
        elif path == "stream":
            want = dec.decode_stream_chunked(x, initial_state=0, final_state=fin)
        elif path == "sharded":
            want = dec.decode_sharded(x, mesh=mesh, initial_state=0, final_state=fin)
        elif path == "wava":
            want = dec.decode_tailbiting(x)[0]
        else:  # soft
            want = dec.decode_soft(x, output="llr", initial_state=0, final_state=fin)
            got = torch.as_tensor(np.stack([t.llrs for t in row]), device=want.device)
            err = (got - want).abs().max().item()
            print(f"{label}: soft LLRs of {len(row)} requests within {err!r} of a "
                  f"direct decode_soft (atol {SERVE_SOFT_ATOL})", flush=True)
            if not err <= SERVE_SOFT_ATOL:
                fail(f"{label}: soft LLRs {err} from a direct decode_soft")
            want = (want < 0).to(torch.int32)
            got = np.stack([t.bits for t in row])
            if not np.array_equal(got, want.cpu().numpy()):
                fail(f"{label}: soft bits differ from a direct decode_soft's signs")
            continue
        got = np.stack([t.bits for t in row])
        if not np.array_equal(got, want.cpu().numpy()):
            n = int((got != want.cpu().numpy()).sum())
            fail(f"{label}: {g['code']} {g['slo']} {g['length']} flushed={g['flushed']} "
                 f"({path}): {n} bits differ from a direct call")
    print(f"{label}: every ticket's bits equal a direct call of its route's entry "
          f"point ({len(groups)} calls, one a request group)", flush=True)


def serve_same_bits(label, tickets, clean):
    for row, want in zip(tickets, clean):
        for t, w in zip(row, want):
            if t.error or not t.done or not np.array_equal(t.bits, w.bits):
                fail(f"{label}: ticket {t.id} ({t.path}, error {t.error}) differs "
                     f"from the clean run's")
    print(f"{label}: every ticket's bits equal the clean run's", flush=True)


def serve_sessions_direct(label, engine, streams, out):
    """Each tenant's output == ``decode_stream_chunked`` on what it
    consumed, tenants of one consumed length in one call."""
    dec = engine._decoder("ccsds-k7")
    by_len = {}
    for sid, (_, n) in out.items():
        by_len.setdefault(n, []).append(sid)
    for n, sids in sorted(by_len.items()):
        x = streams[[int(s[1:]) for s in sids], :n]
        want = dec.decode_stream_chunked(x, chunk_len=SERVE_CHUNK, initial_state=None)
        for sid, row in zip(sids, want.cpu().numpy()):
            if not np.array_equal(out[sid][0], row):
                fail(f"{label}: session {sid} ({n} stages) differs from "
                     f"decode_stream_chunked on what it consumed")
    print(f"{label}: each of {len(out)} tenants' output equals decode_stream_chunked "
          f"on what it consumed ({', '.join(f'{len(s)} x {n}' for n, s in sorted(by_len.items()))} "
          f"stages)", flush=True)


def serve_gate_launches(label, log, mesh_size=0):
    for code, path, f, l, shards, got in log.rows:
        want = serve_want(path, l, shards)
        if got != want:
            fail(f"{label}: a {path} dispatch of {code} (F={f}, T={l}) launched "
                 f"{got}, not {want}")
    print(f"{label}: launches per route {log.per_route()} ({len(log.rows)} dispatches, "
          f"each as its route says)", flush=True)


def serve_clean_stats(label, engine):
    s = engine.stats()
    if s["faults"] or s["degraded"] or s["failed"] or s["retries"]:
        fail(f"{label}: faults {s['faults']}, degraded {s['degraded']}, failed "
             f"{s['failed']}, retries {s['retries']} on a clean run")
    return s


def serve_breakdown(dev, groups):
    """The request traffic once more on a recorder-enabled engine, the
    kernels and every traceback under CUDA events: the engine's span
    totals (host clock) beside the device work they wrap."""
    from repro_torch.codes import tailbiting as tb_mod
    from repro_torch.core import decoder as decoder_mod
    from repro_torch.core import timeparallel as tp_mod
    from repro_torch.core import viterbi as viterbi_mod
    from repro_torch.obs import SpanRecorder

    rec = SpanRecorder()
    eng = serve_engine(dev, recorder=rec)
    patches = kernel_patches(tb=(viterbi_mod, "traceback"),
                             tb_chunk=(decoder_mod, "traceback"),
                             tb_tp=(tp_mod, "traceback"),
                             tb_wava=(tb_mod, "traceback_with_state"))
    with Stages(patches) as st:
        _, wall = host_ms(lambda: (serve_submit(eng, groups, "llrs", 0.0),
                                   eng.drain(now=0.0)))
    spans = {}
    for sp in rec.spans:
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration * 1e3
    tb = sum(st.ms(k) for k in ("tb", "tb_chunk", "tb_tp", "tb_wava"))
    kern = {k: st.ms(k) for k in ("K1", "K2", "K3")}
    print(f"time serve breakdown (recorder on, the requests only): wall "
          f"{wall:.3f} ms; spans (host clock, summed) " + ", ".join(
              f"{k[7:]} {v:.3f}" for k, v in sorted(spans.items()))
          + f" ms; tracebacks {tb:.3f} ms, K1 {kern['K1']:.3f}, K2 {kern['K2']:.3f}, "
          f"K3 (both semirings) {kern['K3']:.3f} ms (CUDA events)", flush=True)
    del st


def serve_phase(dev):
    """Phase 12: the serving engine on the card (``make_decode_engine``):
    the traffic of SERVE_BATCH and SERVE_OTHER and the sessions, every
    route held to direct calls and its launches to the routing table;
    the batch traffic again on a one-card mesh and on two logical
    shards, under a chaos schedule on four shards, and scrubbed with a
    bit flip on two; recorder-enabled runs; an integer-LLR replay whose
    kernel calls are held to their plain versions.  Returns ({route:
    {kernel: launches}} of the clean run and of the sharded route on the
    two meshes, K3-LOGPROB's largest error against its plain version)."""
    from repro_torch.distributed import frame_mesh
    from repro_torch.obs import SpanRecorder
    from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule, FaultEvent

    t_phase = time.perf_counter()
    groups, streams = serve_traffic(dev)
    batch_groups = groups[:len(SERVE_BATCH)]
    n_req = sum(g["bits"].shape[0] for g in groups)
    print(f"phase 12 (serve): {n_req} requests in {len(groups)} groups and "
          f"{SERVE_TENANTS} tenants x {SERVE_CHUNKS} chunks of {SERVE_CHUNK} stages, "
          f"Eb/N0 {SERVE_EBN0} dB, max_batch {SERVE_MAX_BATCH}, session_capacity "
          f"{SERVE_CAPACITY}", flush=True)

    # -- the clean run: the main path, counts zeroed just before --------
    engine = serve_engine(dev)
    log = RouteLog(engine)
    zero_counts()
    t0 = time.perf_counter()
    tickets, t_sub = serve_submit(engine, groups, "llrs", None)
    engine.drain()
    torch.cuda.synchronize()
    t_req = time.perf_counter()
    sessions = serve_sessions(engine, streams, None)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"serve clean run: launches {counts}", flush=True)
    for kernel in ("K1", "K2", "K3", "K3-LOGPROB"):
        if not counts.get(kernel):
            fail(f"serve clean run: {kernel} was not launched")
    serve_gate_launches("serve clean run", log)
    stats = serve_clean_stats("serve clean run", engine)
    routes = {}
    for b in engine.batch_log:
        r = routes.setdefault(b["path"], [0, 0])
        r[0] += 1
        r[1] += b["n_real"]
    print("serve routes (cells, requests or session chunks): " + ", ".join(
        f"{p} {c} cells / {n}" for p, (c, n) in sorted(routes.items())), flush=True)
    frames = engine.registry.counter("engine_frames_total")
    elems = engine.registry.counter("engine_llr_elems_total")
    pf, rf = frames.total(kind="pad"), frames.total(kind="real")
    pe, re_ = elems.total(kind="pad"), elems.total(kind="real")
    print(f"serve padding: {pf:.0f} pad frames over {rf:.0f} real ({pf / rf:.4f}); "
          f"{pe:.0f} pad LLR elements over {re_:.0f} real ({pe / re_:.4f}); occupancy "
          f"{stats['occupancy']:.4f}, padding_waste {stats['padding_waste']:.4f}", flush=True)
    n_bits = sum(t.n_out for row in tickets for t in row)
    n_sess = sum(b.shape[0] for b, _ in sessions.values())
    wall_req, wall_sess = (t_req - t0) * 1e3, (t_end - t_req) * 1e3
    print(f"time serve requests: {n_req} submitted and drained in {wall_req:.3f} ms "
          f"(host clock), {mbps(n_bits, wall_req)} of decoded stages; sessions "
          f"{wall_sess:.3f} ms, {mbps(n_sess, wall_sess)}", flush=True)
    soj = np.array([t_req - ts for ts in t_sub]) * 1e3
    lat = {slo: (v["p50"] * 1e3, v["p99"] * 1e3) for slo, v in stats["latency"].items()}
    print(f"serve sojourn (host clock): submit -> drain's return p50 "
          f"{np.percentile(soj, 50):.3f} ms, p99 {np.percentile(soj, 99):.3f} ms; the "
          f"engine's submit -> completion stamp (ms, p50/p99) {lat}", flush=True)
    serve_direct("serve clean run", engine, groups, tickets)
    serve_sessions_direct("serve clean run", engine, streams, sessions)

    # -- the batch traffic on a one-card mesh and on two logical shards --
    per_route = log.per_route()
    for label, mesh in (("serve one-card mesh", frame_mesh()),
                        ("serve two shards", frame_mesh(2, device=dev))):
        eng = serve_engine(dev, mesh=mesh)
        rlog = RouteLog(eng)
        got, _ = serve_submit(eng, batch_groups, "llrs", 0.0)
        eng.drain(now=0.0)
        serve_gate_launches(label, rlog)
        per_route[f"sharded, {mesh.size} shard{'s' * (mesh.size > 1)}"] = (
            rlog.per_route()["sharded"])
        serve_clean_stats(label, eng)
        paths = {t.path for row in got for t in row}
        if "sharded" not in paths or not paths <= {"sharded", "stream"}:
            fail(f"{label}: routes {paths}, not the sharded route")
        serve_same_bits(label, got, tickets)
        serve_direct(label, eng, batch_groups, got, mesh=mesh)

    # -- chaos: failover 4 -> 2 -> 1 shard, then batch -------------------
    sched = ChaosSchedule([
        FaultEvent(at=0, kind="device_failure", device=3, path="sharded"),
        FaultEvent(at=2, kind="timeout", path="sharded"),
        FaultEvent(at=4, kind="device_failure", device=1, path="sharded"),
        FaultEvent(at=5, kind="compile_error", path="sharded"),
        FaultEvent(at=7, kind="device_failure", device=0, path="sharded"),
        FaultEvent(at=12, kind="timeout", path="session"),
    ])
    inj = ChaosInjector(sched)
    eng = serve_engine(dev, mesh=frame_mesh(4, device=dev), chaos=inj)
    got, _ = serve_submit(eng, batch_groups, "llrs", 0.0)
    eng.drain(now=0.0)
    sess = serve_sessions(eng, streams, 0.0)
    s = eng.stats()
    print(f"serve chaos: faults {s['faults']}, retries {s['retries']}, degraded "
          f"{s['degraded']}, failovers {s['failovers']}; routes "
          f"{[row[0].path for row in got]}; mesh after {eng.mesh}", flush=True)
    want_faults = {"device_failure": 3, "timeout": 2, "compile_error": 1}
    if (s["faults"] != want_faults or s["retries"] != 5 or s["degraded"] != 1
            or s["failovers"] != 3 or eng.mesh is not None or s["failed"]
            or dict(inj.injected) != want_faults):
        fail(f"serve chaos: not as scheduled (want faults {want_faults}, 5 retries, "
             f"1 degradation, 3 failovers, no mesh left)")
    # per request group (SERVE_BATCH order), the route its cell ended on:
    # dispatches 0-1 (flushed 1000) and 2-3 (the 1024 rung) on two shards,
    # 4-6 (flushed 3000) on one, 7-8 (the 4096 rung) degraded to batch,
    # flushed 6000 with no mesh left on batch, the 8192 cells on stream
    want_paths = ["sharded", "sharded", "batch", "sharded", "stream", "batch",
                  "stream", "stream"]
    if [row[0].path for row in got] != want_paths:
        fail(f"serve chaos: routes {[row[0].path for row in got]}, not {want_paths}")
    serve_same_bits("serve chaos", got, tickets)
    for sid, (bits, n) in sess.items():
        if not np.array_equal(bits, sessions[sid][0]):
            fail(f"serve chaos: session {sid} differs from the clean run's")
    print("serve chaos: sessions equal the clean run's", flush=True)

    # -- scrub: one bit flip on two shards, quarantined ------------------
    flip = FaultEvent(at=0, kind="bit_flip", device=1, flips=1)
    eng = serve_engine(dev, mesh=frame_mesh(2, device=dev), scrub=1.0,
                       chaos=ChaosInjector(ChaosSchedule([flip])))
    got, _ = serve_submit(eng, batch_groups, "llrs", 0.0)
    eng.drain(now=0.0)
    sess = serve_sessions(eng, streams, 0.0)
    # the flipped position as ChaosInjector.corrupt draws it: dispatch 0 is
    # the cell of the flushed 1000-stage requests (the first queue key),
    # its frames in submission order
    row, n = got[1], got[1][0].n_out
    pos = np.random.default_rng(1_000_003 * (flip.at + 1) + 17).choice(
        len(row) * n, size=flip.flips, replace=False)
    hit = sorted({int(p) // n for p in pos})
    detected = [i for i, t in enumerate(row) if t.error == "sdc_detected"]
    n_detected = sum(t.error == "sdc_detected" for r in got for t in r)
    s = eng.stats()
    print(f"serve scrub: bit flipped in request {hit} of the first cell; "
          f"sdc_detected {detected} ({n_detected} in all); scrub {s['scrub']}; "
          f"quarantined {s['quarantined']}; mesh after {eng.mesh}", flush=True)
    if (detected != hit or n_detected != len(hit) or s["quarantined"] != [1]
            or eng.mesh is None or eng.mesh.ids != (0,)
            or s["scrub"]["false_alarms"] or s["scrub"]["confirmed"] != len(hit)):
        fail("serve scrub: not exactly the corrupted ticket detected and its "
             "device quarantined")
    for row, want in zip(got, tickets):
        for t, w in zip(row, want):
            if t.error is None and not np.array_equal(t.bits, w.bits):
                fail(f"serve scrub: clean ticket {t.id} differs from the clean run's")
    for sid, (bits, n) in sess.items():
        if not np.array_equal(bits, sessions[sid][0]):
            fail(f"serve scrub: session {sid} differs from the clean run's")
    print("serve scrub: every other ticket and every session equal the clean run's",
          flush=True)

    # -- recorder-enabled runs: dispatch seconds beside K1; where a
    # request's time goes -------------------------------------------------
    rec = SpanRecorder()
    eng = serve_engine(dev, recorder=rec)
    cell = batch_groups[3:4]  # the flushed 3000-stage requests, one cell
    with Stages(kernel_patches()) as st:
        serve_submit(eng, cell, "llrs", 0.0)
        eng.drain(now=0.0)
    hist = eng.registry.histogram("engine_dispatch_seconds")
    wait = rec.find("engine.device_wait")[0].duration
    print(f"time serve recorder run: one batch cell of 32 x 3000 stages: "
          f"engine_dispatch_seconds {hist.sum_() * 1e3:.3f} ms ({hist.count()} "
          f"sample), its engine.device_wait span {wait * 1e3:.3f} ms; K1 "
          f"{st.ms('K1'):.3f} ms (CUDA events)", flush=True)
    del st
    serve_breakdown(dev, groups)

    # -- the integer-LLR replay: kernel calls held to their plain versions
    eng = serve_engine(dev)
    with Stages(kernel_patches(), keep=("K1", "K2", "K3")) as st:
        serve_submit(eng, groups, "quant", 0.0)
        eng.drain(now=0.0)
        serve_sessions(eng, torch.clamp(torch.round(streams), -16, 16), 0.0)
    kept = st.kept
    lp = [i for i, c in enumerate(kept) if c[0] == "K3" and c[2]["semiring"] == "logprob"]
    k2 = [i for i, c in enumerate(kept) if c[0] == "K2"]
    exact = [i for i, c in enumerate(kept) if c[0] in ("K1", "K3") and i not in lp]
    # K2's plain version walks its ring of D + TT steps for every tile in
    # Python (64 walks of 2592 steps for a 2048-step chunk at D = 2560):
    # every K2 call is held on its first, middle and last tiles
    hold_kept("serve integer-LLR replay", st, pick=exact)
    t_k2 = time.perf_counter()
    n_tiles = sum(hold_k2_tiles(f"serve K2 call {n} of {len(k2)} ({kept[i][1][0].shape[1]} "
                                f"frames; integer LLRs)", kept[i])
                  for n, i in enumerate(k2, 1))
    print(f"time serve K2 holds: {len(k2)} calls, {n_tiles} tiles against the plain "
          f"version in {time.perf_counter() - t_k2:.3f} s (host clock)", flush=True)
    err = max(hold_logprob_k3("serve soft route (integer LLRs)", kept[i]) for i in lp)
    del st, kept
    print(f"phase 12 (serve) took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {SERVE_BUDGET_S} s)", flush=True)
    return per_route, {"K3-LOGPROB": err}


# -- phase 13: the serving launcher -------------------------------------------

LAUNCH_BER_LIMIT = 1e-3  # the reference's expectation for the launcher at 4 dB
LAUNCH_HOLD_STREAMS, LAUNCH_HOLD_LEN = 16, 8192  # integer-LLR runs: streams x stages
LAUNCH_HOLD_TBCC = 512  # integer-LLR run of lte-tbcc: blocks
LAUNCH_HOLD_TP_LEN = 65536  # integer-LLR runs of the time-parallel paths: stages
LAUNCH_SHARDS = 4  # logical shards of the time-sharded decode
LAUNCH_ENGINE = ("--service", "engine", "--slo", "mixed", "--streams", "64",
                 "--stream-len", "8192", "--batches", "2")
LAUNCH_CHAOS = (("device_failure", 0), ("timeout", 2), ("compile_error", 4))
# every 4th dispatch scrubbed (the scrubber's cadence): 2 of the engine
# run's 8 dispatches; at 0.1 it would sample none of them
LAUNCH_SCRUB_RATE = 0.25
LAUNCH_SMOKE_REPS = 5  # obs.smoke's timed repetitions a mode
LAUNCH_BUDGET_S = 60  # phase 13's time budget, printed beside its seconds


def launcher_modes():
    """(label, argv, {kernel: launches} of each call of the decode
    function, the entry point its bits are held to, BER limit, (streams,
    stages) of its integer-LLR run) of every ``--service viterbi`` run of
    phase 13."""
    from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS

    def shape(f, n):
        return ["--service", "viterbi", "--streams", str(f), "--stream-len", str(n),
                "--batches", "1"]

    full, hold = shape(F_FULL, N_FULL), (LAUNCH_HOLD_STREAMS, LAUNCH_HOLD_LEN)
    k2 = ["--use-kernel"]
    return (
        ("tiled", full + ["--mode", "tiled"] + k2, {"K2": 1}, "tiled",
         LAUNCH_BER_LIMIT, hold),
        ("chunked", full + ["--mode", "chunked"] + k2, {"K2": N_FULL // CHUNK_LEN},
         "chunked", LAUNCH_BER_LIMIT, hold),
        # 512 frames at the smaller depth: F x S stays over the card's
        # time-parallel budget, so the run keeps the sequential path
        ("batch", full + ["--mode", "batch"], {"K1": 1}, "batch", LAUNCH_BER_LIMIT,
         (F_FULL, LAUNCH_HOLD_LEN)),
        ("sharded", full + ["--mode", "sharded"] + k2,
         {"K2": torch.cuda.device_count()}, "tiled", LAUNCH_BER_LIMIT, hold),
        ("time_parallel", shape(F_TP, N_TP) + ["--mode", "time_parallel"],
         {"K3": 1, "K1": 1}, "time_parallel", LAUNCH_BER_LIMIT,
         (F_TP, LAUNCH_HOLD_TP_LEN)),
        ("tiled --optimized", full + ["--optimized", "--mode", "tiled"] + k2,
         {"K2": 1}, "tiled", LAUNCH_BER_LIMIT, hold),
        ("wifi-11a-r34 tiled", full + ["--code", "wifi-11a-r34", "--ebn0",
                                       str(EBN0_CODES), "--mode", "tiled"] + k2,
         {"K2": 1}, "tiled", BER_LIMIT, hold),
        ("lte-tbcc", shape(F_TBCC_CELL, N_TBCC_CELL) + [
            "--code", "lte-tbcc", "--ebn0", str(EBN0_CODES)],
         {"K1": DEFAULT_WAVA_ITERS}, "tailbiting", TBCC_BER_LIMIT,
         (LAUNCH_HOLD_TBCC, N_TBCC_CELL)),
    )


def launcher_run(label, argv, want):
    """``launch.serve.main(argv)``, the main path of one mode: counts
    zeroed just before, read just after, and each call of the decode
    function ``_viterbi_run_fn`` built (the warm-up and the timed batch)
    counted on its own; fails unless every call launched ``want``.
    Returns (the launcher's report, the launches read)."""
    from repro_torch.launch import serve

    calls, build = [], serve._viterbi_run_fn

    def counted_build(vcfg, args):
        run = build(vcfg, args)

        def counted(llrs):
            before = launch_counts()
            out = run(llrs)
            torch.cuda.synchronize()
            after = launch_counts()
            calls.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
            return out
        counted.mesh = getattr(run, "mesh", None)
        return counted

    serve._viterbi_run_fn = counted_build
    zero_counts()
    try:
        (rep, wall), paths = dispatched(lambda: host_ms(lambda: serve.main(argv)))
    finally:
        serve._viterbi_run_fn = build
    got = {k: v for k, v in launch_counts().items() if v}
    print(f"launcher {label}: {len(calls)} calls of the decode function (the warm-up "
          f"and the timed batch), launches a call {calls}, in all {got}; dispatch "
          f"{paths}; main() {wall:.3f} ms (host clock, input drawn on the card "
          f"included)", flush=True)
    print(f"time launcher {label}: the timed batch {rep['seconds'] * 1e3:.3f} ms "
          f"(host clock, its draw on the card included, as the report line times "
          f"it), {rep['mbps']:.3f} Mb/s", flush=True)
    if len(calls) < 2 or any(c != want for c in calls):
        fail(f"launcher {label}: launched {calls}, not {want} a call")
    return rep, got


def launcher_direct(label, kind, args, vcfg, rep, dev):
    """Hold the timed batch's bits to a direct call, on the same card LLRs,
    of the entry point the mode names: ``decode_stream_tiled`` on the
    first, middle and last streams, or the batch entry point on the whole
    batch."""
    from repro_torch.serve.step import make_viterbi_decoder

    _, llrs, out = rep["last"]
    dec = make_viterbi_decoder(vcfg, decision_depth=args.decision_depth,
                               one_pass=args.use_kernel, device=dev)
    if kind == "tiled":
        cfg = dec.default_tiled_config(vcfg.tiled)
        n = llrs.shape[0]
        for i in sorted({0, n // 2, n - 1}):
            if not torch.equal(out[i], dec.decode_stream_tiled(llrs[i], cfg)):
                fail(f"launcher {label}: stream {i} differs from decode_stream_tiled")
        print(f"launcher {label}: streams 0, {n // 2} and {n - 1} equal "
              f"decode_stream_tiled on each alone", flush=True)
        return
    if kind == "chunked":
        want = dec.decode_stream_chunked(llrs, chunk_len=args.chunk_len,
                                         initial_state=None)
    elif kind == "batch":
        want = dec.decode_batch(llrs, initial_state=None, final_state=None)
    elif kind == "time_parallel":
        want = dec.decode_batch(llrs, initial_state=None, final_state=None,
                                time_parallel=True)
    else:
        want = dec.decode_tailbiting(llrs)[0]
    gate_equal(f"launcher {label}: bits == a direct {kind} call on the whole batch",
               out, want)


def launcher_hold(label, args, vcfg, shape, dev, want):
    """The mode's decode function on integer LLRs at a smaller shape, on
    the main path's kernels (``want``'s): every K1 and K3 call held bit
    for bit to its plain version, every K2 call on its first, middle and
    last tiles."""
    import dataclasses

    from repro_torch.data.pipeline import ChannelStream
    from repro_torch.launch import serve

    f, n = shape
    small = dataclasses.replace(vcfg, stream_len=n, batch_streams=f)
    run = serve._viterbi_run_fn(small, args)
    _, llrs = ChannelStream(spec=small.spec, n_streams=f, stream_len=n,
                            ebn0_db=args.ebn0, code=args.code, seed=SEED + 13,
                            device=dev).batch_at(0)
    quant = torch.clamp(torch.round(llrs), -16, 16)
    _, st = kept_run(lambda: run(quant), ("K1", "K2", "K3"))
    kernels = {c[0] for c in st.kept}
    if kernels != set(want):
        fail(f"launcher {label} (integer LLRs, {f} x {n}) ran {sorted(kernels)}, "
             f"not the main path's {sorted(want)}")
    exact = [i for i, c in enumerate(st.kept) if c[0] in ("K1", "K3")]
    k2 = [i for i, c in enumerate(st.kept) if c[0] == "K2"]
    if exact:
        hold_kept(f"launcher {label} (integer LLRs, {f} x {n})", st, pick=exact)
    for j, i in enumerate(k2, 1):
        hold_k2_tiles(f"launcher {label} K2 call {j} of {len(k2)} (integer LLRs, "
                      f"{f} x {n})", st.kept[i])


def launcher_time_sharded(dev):
    """``sharded_decode_time_parallel`` on four logical shards of the card
    at decode_512k_f16's shape, on phase 9's AWGN codeword LLRs: one K3
    and one K1 a shard, BER, bits == phase 9's sequential decode; then
    its kernel calls held on an integer-LLR run.  Returns the launches."""
    from repro_torch.core import CODE_K7_CCSDS
    from repro_torch.distributed import frame_mesh, sharded_decode_time_parallel

    llrs, bits_seq, info = TP_CELL["llrs"], TP_CELL["bits_seq"], TP_CELL["info"]
    mesh = frame_mesh(LAUNCH_SHARDS, axis="tiles", device=dev)
    label = f"sharded_decode_time_parallel ({LAUNCH_SHARDS} shards, {F_TP} x {N_TP})"

    def decode(x):
        return sharded_decode_time_parallel(x, CODE_K7_CCSDS, mesh=mesh,
                                            initial_state=0)

    zero_counts()
    bits, wall = host_ms(lambda: decode(llrs))
    got = {k: v for k, v in launch_counts().items() if v}
    print(f"{label}: launches {got}; wall {wall:.3f} ms (host clock)", flush=True)
    if got != {"K3": LAUNCH_SHARDS, "K1": LAUNCH_SHARDS}:
        fail(f"{label} launched {got}, not one K3 and one K1 a shard")
    gate_ber(f"{label} AWGN", bits, info, BER_LIMIT)
    if not torch.equal(bits, bits_seq):
        rows, gap, mag = path_metric_ties(llrs, bits, bits_seq, CODE_K7_CCSDS)
        fail(f"{label}: {int((bits != bits_seq).sum())} bits in {rows} frames differ "
             f"from the sequential path (largest path-metric gap {gap!r} at "
             f"|metric| up to {mag!r})")
    print(f"{label}: bits == the sequential path's (phase 9's decode_batch on the "
          f"same AWGN codeword LLRs)", flush=True)
    walls = sorted(host_ms(lambda: decode(llrs))[1] for _ in range(3))
    print(f"time {label}: wall {walls[1]:.3f} ms (median of "
          f"{', '.join(f'{w:.3f}' for w in walls)}; host clock); decoded "
          f"{mbps(F_TP * N_TP, walls[1])}", flush=True)
    quant = torch.clamp(torch.round(llrs[:, :LAUNCH_HOLD_TP_LEN]), -16, 16)
    _, st = kept_run(lambda: decode(quant), ("K1", "K3"))
    hold_kept(f"{label} (integer LLRs, {F_TP} x {LAUNCH_HOLD_TP_LEN})", st)
    return got


def launcher_engine(label, argv):
    """``launch.serve.main(argv)`` of the engine service, the engine it
    builds logged by ``RouteLog``: counts zeroed just before, read just
    after.  Returns (report, the launches read, the engine, its
    RouteLog)."""
    from repro_torch.launch import serve
    from repro_torch.serve import step as step_mod

    made, make = [], step_mod.make_decode_engine

    def logged(**kw):
        engine = make(**kw)
        made.append((engine, RouteLog(engine)))
        return engine

    step_mod.make_decode_engine = logged
    zero_counts()
    try:
        rep, wall = host_ms(lambda: serve.main(argv))
    finally:
        step_mod.make_decode_engine = make
    got = {k: v for k, v in launch_counts().items() if v}
    engine, log = made[0]
    print(f"launcher {label}: {rep['requests']} requests, launches {got}, per route "
          f"{log.per_route()}; errors {rep['errored']}, dropped {rep['dropped']}; BER "
          f"{rep['ber']:.3e} (printed, not gated); main() {wall:.3f} ms (host clock, "
          f"input drawn on the card included)", flush=True)
    if rep["errored"] or rep["dropped"]:
        fail(f"launcher {label}: {rep['errored']} requests errored, "
             f"{rep['dropped']} dropped")
    return rep, got, engine, log


def launcher_gate_main(label, module, argv):
    """A gate's ``main(argv)`` on the card: counts zeroed just before, read
    just after; fails unless it returns 0 (its assertions end the run)."""
    t0 = time.perf_counter()
    zero_counts()
    try:
        rc = module.main(argv)
    except AssertionError as exc:
        fail(f"{label} failed its gate: {exc}")
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    print(f"{' '.join([label] + argv)}: exit {rc}; launches {got}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        fail(f"{label} exited {rc}")
    return got


def launcher_phase(dev):
    """Phase 13: the serving launcher on the card, through the port's own
    entry points: ``launch.serve.main`` in each ``--mode`` and config,
    ``sharded_decode_time_parallel`` on four shards, the engine service
    (clean with its metrics log, then under chaos with checkpoints and
    scrubbing) and ``obs.top`` on its log, and the three gate mains.
    Returns {run: {kernel: launches}} of the main-path runs."""
    import json as json_mod
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.obs import smoke as obs_smoke
    from repro_torch.obs import top
    from repro_torch.runtime import chaos_smoke
    from repro_torch.runtime.chaos import ChaosSchedule, FaultEvent
    from repro_torch.verify import scrub_smoke

    t_phase = time.perf_counter()
    launches = {}
    print(f"phase 13 (launcher): launch.serve --service viterbi at {F_FULL} x {N_FULL} "
          f"stages, each mode in turn", flush=True)
    for label, argv, want, kind, limit, hold in launcher_modes():
        t0 = time.perf_counter()
        rep, launches[label] = launcher_run(label, argv, want)
        args = serve._parser().parse_args(argv)
        vcfg = serve._viterbi_config(args)
        bits, _, out = rep["last"]
        gate_ber(f"launcher {label} ({rep['tag']}, the timed batch)", out, bits, limit)
        launcher_direct(label, kind, args, vcfg, rep, dev)
        del rep, bits, out
        launcher_hold(label, args, vcfg, hold, dev, want)
        print(f"launcher {label} took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    launches["sharded_decode_time_parallel"] = launcher_time_sharded(dev)
    print(f"time-sharded decode took {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        jsonl = str(Path(tmp) / "engine.jsonl")
        rep, launches["engine"], engine, log = launcher_engine(
            "engine", list(LAUNCH_ENGINE) + ["--metrics-jsonl", jsonl])
        serve_gate_launches("launcher engine", log)
        serve_clean_stats("launcher engine", engine)
        if top.main(["--jsonl", jsonl]) != 0:
            fail("obs.top --jsonl: no metrics line in the engine's log")
        clean_errors, clean = rep["errors"], rep["stats"]
        del rep, engine, log

        sched = Path(tmp) / "chaos.json"
        sched.write_text(json_mod.dumps(ChaosSchedule([
            FaultEvent(at=at, kind=kind, **({"device": 0} if kind == "device_failure"
                                            else {}))
            for kind, at in LAUNCH_CHAOS]).to_json()))
        rep, launches["engine --chaos"], engine, _ = launcher_engine(
            "engine --chaos --checkpoint-dir --scrub-rate", list(LAUNCH_ENGINE) + [
                "--chaos", str(sched), "--checkpoint-dir", str(Path(tmp) / "ckpt"),
                "--scrub-rate", str(LAUNCH_SCRUB_RATE)])
        s = rep["stats"]
        want_faults = {kind: 1 for kind, _ in LAUNCH_CHAOS}
        print(f"launcher engine --chaos: faults {s['faults']}, retries {s['retries']}, "
              f"degraded {s['degraded']}, failovers {s['failovers']}, checkpoints "
              f"{s['checkpoints']}; scrub {s['scrub']}, quarantined "
              f"{s['quarantined']}", flush=True)
        sc, want_sampled = s["scrub"], int(s["batches"] * LAUNCH_SCRUB_RATE + 1e-9)
        if (s["faults"] != want_faults or s["retries"] != len(LAUNCH_CHAOS)
                or s["degraded"] or s["failovers"] != 1 or not s["checkpoints"]
                or sc["sampled"] != want_sampled or sc["frames"] < want_sampled
                or sc["confirmed"] or sc["syndrome_flags"] != sc["false_alarms"]
                or s["quarantined"]):
            fail(f"launcher engine --chaos: not as scheduled (want faults "
                 f"{want_faults}, {len(LAUNCH_CHAOS)} retries, 1 failover, a "
                 f"checkpoint, {want_sampled} of {s['batches']} dispatches scrubbed "
                 f"with every flag cleared by the shadow decode)")
        if rep["errors"] != clean_errors or s["paths"] != clean["paths"]:
            fail(f"launcher engine --chaos: {rep['errors']} bit errors on paths "
                 f"{s['paths']}, the clean run {clean_errors} on {clean['paths']}")
        print(f"launcher engine --chaos: the clean run's bit errors "
              f"({clean_errors}) and paths", flush=True)
        del rep, engine
        print(f"launcher engine runs took {time.perf_counter() - t0:.1f} s", flush=True)

    for label, module, argv in (
            ("obs.smoke", obs_smoke, ["--reps", str(LAUNCH_SMOKE_REPS)]),
            ("runtime.chaos_smoke", chaos_smoke, []),
            ("verify.scrub_smoke", scrub_smoke, [])):
        launches[label] = launcher_gate_main(label, module, argv)
    print(f"phase 13 (launcher) took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {LAUNCH_BUDGET_S} s)", flush=True)
    return launches


# -- phase 14: verification and tooling ---------------------------------------

VERIFY_BUDGET_S = 60  # phase 14's time budget, printed beside its seconds
# the farm's --full grid (verify/farm.py): its codes and paths; on the card
# at frames of 512 stages (256 radix steps), where the time-parallel plan
# engages (4 tiles of 64 steps; at the farm's default of 256 stages it
# refuses 2 tiles and that path decodes sequentially), in batches of 64
VERIFY_CODES = ("ccsds-k7", "wifi-11a-r34", "lte-tbcc", "gsm-cs1")
VERIFY_PATHS = ("reference", "kernel", "time_parallel", "engine", "sharded")
VERIFY_BUDGET_STAGES, VERIFY_BATCH = 512, 64
VERIFY_FULL_FRAMES = 1024  # frames a point of the --full grid (about 35 s)
VERIFY_SHARDS = 2  # logical shards of the sharded farm
VERIFY_SHARD_GRID = dict(codes=["ccsds-k7", "lte-tbcc"], ebn0_dbs=[2.0, 3.0],
                         paths=("reference", "time_parallel"), frames_per_point=256,
                         frame_budget=VERIFY_BUDGET_STAGES, batch_frames=VERIFY_BATCH,
                         seed=1)
VERIFY_EBN0 = 2.0  # the launch and hold batches: deep enough in the waterfall for errors


def verify_main(label, module, argv):
    """``module.main(argv)`` on the card, its standard output kept and its
    summary lines printed: counts zeroed just before, read just after;
    fails unless it returns 0.  Returns the launches read."""
    import contextlib
    import io

    t0 = time.perf_counter()
    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        try:
            rc = module.main(argv)
        except AssertionError as exc:
            fail(f"{label} failed its gate: {exc}")
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    lines = out.getvalue().splitlines()
    keep = [ln for ln in lines if not ln.startswith(("gate PASS", "ccsds", "wifi",
                                                     "lte", "gsm"))]
    for line in keep:
        print(f"  {line}")
    verdicts = [ln for ln in lines if ln.startswith("gate ")]
    if verdicts:
        exact = sum(": exact:" in ln for ln in verdicts)
        print(f"  gate verdicts: {exact} on identical counts, {len(verdicts) - exact} "
              f"by interval overlap or failed", flush=True)
    print(f"{' '.join([label] + argv)}: exit {rc}; launches {got}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        fail(f"{label} exited {rc}:\n" + "\n".join(lines[-40:]))
    return got, lines


def verify_want(farm, name, path, n_frames, n_stages):
    """The launches ``farm.decode_fn(name, path)`` implies for one batch of
    ``n_frames`` frames of ``n_stages`` transmit stages: the decoder's
    own rules (the one-pass rule a chunk, the time-parallel plan, WAVA's
    circulations, the engine's routing table)."""
    from repro_torch.codes import get_code
    from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS
    from repro_torch.core.kernel_geometry import pick_cell_frames

    circulations = DEFAULT_WAVA_ITERS if get_code(name).termination == "tailbiting" else 0
    if path == "engine":
        engine = farm._engine_obj()
        f_cell = pick_cell_frames(n_frames, engine.max_batch)
        route = engine._pick_path(name, "throughput", f_cell, n_stages)
        if route != "wava":
            return route, serve_want(route, n_stages, 0)
        # the engine's WAVA is on auto: the card's budget may take it
        # time-parallel
        dec = engine._decoder(name)
        tile = dec._time_parallel_tile(f_cell, n_stages // dec.rho, None)
        return f"wava, time-parallel tile {tile}", {
            "K1": circulations, **({"K3": 1} if tile else {})}
    dec = farm._decoder(name, path, farm.device)
    steps = n_stages // dec.rho
    if path == "time_parallel":
        tile = dec._time_parallel_tile(n_frames, steps, True)
        want = {"K1": circulations or 1, **({"K3": 1} if tile else {})}
        return f"time-parallel tile {tile}", want
    if circulations:
        return "wava", {"K1": circulations}
    if path == "kernel":
        chunk = 4096  # decode_stream_chunked's default chunk, in stages
        n_chunks = -(-n_stages // chunk)
        tile = dec._one_pass_tile(min(chunk, n_stages) // dec.rho,
                                  dec.decision_depth // dec.rho)
        return f"one-pass tile {tile}", {"K2" if tile else "K1": n_chunks}
    if path == "sharded":
        return "sharded", {"K1": torch.cuda.device_count()}
    return "batch", {"K1": 1}


def verify_paths(dev):
    """Each (code, path) of the --full grid and the sharded path: one
    AWGN batch's launches held to what ``decode_fn`` implies, then an
    integer-LLR batch whose every kernel call is held to its plain
    version on the same tensors.  Returns
    {path: {kernel: launches}} summed over the codes."""
    from repro_torch.codes import get_code
    from repro_torch.codes.simulate import batch_keys, sim_frame_batch
    from repro_torch.verify.farm import BerFarm, _message_bits

    farm = BerFarm(VERIFY_CODES, [VERIFY_EBN0], paths=VERIFY_PATHS,
                   batch_frames=VERIFY_BATCH, frame_budget=VERIFY_BUDGET_STAGES)
    per_path = {}

    for name in VERIFY_CODES:
        code = get_code(name)
        n_msg = _message_bits(code, VERIFY_BUDGET_STAGES)
        seed = batch_keys(SEED, name, VERIFY_EBN0, 1)[0]
        gen = torch.Generator(device=dev).manual_seed(seed)
        bits, llrs = sim_frame_batch(gen, code, VERIFY_BATCH, n_msg, VERIFY_EBN0)
        quant = torch.clamp(torch.round(llrs), -16, 16)
        ref_bits = None
        for path in VERIFY_PATHS:
            label = f"farm {name}/{path}"
            if path == "sharded" and code.termination == "tailbiting":
                try:
                    farm.decode_fn(name, path)
                except ValueError:
                    print(f"{label}: refused (tail-biting frames are not sharded, "
                          f"as in the reference)", flush=True)
                    continue
                fail(f"{label}: a tail-biting code was not refused")
            fn = farm.decode_fn(name, path)
            rule, want = verify_want(farm, name, path, VERIFY_BATCH, VERIFY_BUDGET_STAGES)
            zero_counts()
            out = fn(llrs)
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            errors = int((out[:, :n_msg].to(dev) != bits).sum())
            print(f"{label}: {VERIFY_BATCH} x {VERIFY_BUDGET_STAGES} stages at "
                  f"{VERIFY_EBN0:g} dB, launches {got} ({rule}: want {want}); "
                  f"{errors} bit errors", flush=True)
            if got != want:
                fail(f"{label} launched {got}, not {want}")
            acc = per_path.setdefault(path, {})
            for k, v in got.items():
                acc[k] = acc.get(k, 0) + v
            # every path decodes the reference path's bits on the same batch
            # (exact ML on AWGN LLRs; WAVA's time-parallel circulations may
            # differ, which the gate prices)
            if ref_bits is None:
                ref_bits = out
            elif not (code.termination == "tailbiting" and "K3" in got):
                gate_equal(f"{label}: bits == the reference path's", out.to(dev),
                           ref_bits.to(dev))
            _, stages = kept_run(lambda: fn(quant), keep=("K1", "K2", "K3"))
            if not stages.kept:
                fail(f"{label}: the integer-LLR run called no kernel")
            hold_kept(f"{label} (integer LLRs)", stages)
    return per_path


def verify_sharded(dev):
    """The sharded farm: the mesh paths' seeds split over two logical
    shards of the card; every point's counts equal the single-device
    farm's.  Returns the sharded run's launches."""
    from repro_torch.distributed.decoder import frame_mesh
    from repro_torch.verify.farm import BerFarm

    single = BerFarm(**VERIFY_SHARD_GRID).run()
    zero_counts()
    t0 = time.perf_counter()
    sharded = BerFarm(mesh=frame_mesh(VERIFY_SHARDS, device=dev), **VERIFY_SHARD_GRID).run()
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    for a, b in zip(single, sharded, strict=True):
        print(f"farm sharded {b.code}/{b.path}@{b.ebn0_db:g}: {b.n_frames} frames on "
              f"{VERIFY_SHARDS} shards, {b.bit_errors} bit and {b.frame_errors} frame "
              f"errors; one device {a.bit_errors} and {a.frame_errors}", flush=True)
        if a != b:
            fail(f"farm sharded {b.code}/{b.path}@{b.ebn0_db:g}: counts differ from "
                 f"the single-device farm's")
    print(f"farm sharded: {len(sharded)} points on {VERIFY_SHARDS} logical shards == one "
          f"device's, launches {got}; {time.perf_counter() - t0:.1f} s", flush=True)
    return got


def verify_traffic(dev):
    """The traffic report at the acceptance shape, with the one-pass
    ratio, and its premise held to the launcher: K2's geometry on this
    card puts the rings in shared memory there."""
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.kernel_geometry import pick_time_tile
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.traffic import streaming_traffic_report

    rep = streaming_traffic_report()
    shape = rep["shape"]
    tables = build_acs_tables(CODE_K7_CCSDS, 2)
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    w = torch.as_tensor(tables.fused_w, device=dev)
    n_cols = viterbi_acs.gather_operands(w, B, S, R).cols.shape[1]
    T, D = shape["n_stages"] // 2, shape["decision_depth"] // 2
    geo = viterbi_acs.k2_launch_geometry(S, R, B, n_cols, D, pick_time_tile(D, T), True,
                                         shape["n_frames"])
    print(f"traffic (kernels.traffic, static model) at T={shape['n_stages']} stages, "
          f"F={shape['n_frames']}, depth {shape['decision_depth']}: two-pass "
          f"{rep['two_pass']['total_bytes']} B, packed two-pass "
          f"{rep['two_pass_packed']['total_bytes']} B, one-pass "
          f"{rep['one_pass']['total_bytes']} B; ratio {rep['ratio']} "
          f"(packed {rep['ratio_vs_packed']}); K2 on this card: {geo}", flush=True)
    if rep["ratio"] < 5.0 or not rep["k2_ring_in_smem"]:
        fail("traffic: the one-pass ratio is under 5 or K2's rings leave shared memory")
    if not geo["rings_in_smem"]:
        fail("traffic: K2's launch puts the rings in device memory at the acceptance "
             "shape, against the model's premise")


def verify_profile(dev):
    """An engine run with the recorder on, against the same run with it
    off: the same bits, and every dispatch span carries the modelled
    profile (``obs.profile``) and its achieved fractions against the
    H100 entry, none above 1.0.  Returns the recorder-on run's
    launches."""
    from repro_torch.obs import NullRecorder, SpanRecorder
    from repro_torch.roofline import H100
    from repro_torch.serve import DecodeRequest, make_decode_engine

    reqs = []
    for name, n_frames, n_msg, slo in (
            ("ccsds-k7", 64, 2042, "throughput"), ("ccsds-k7", 8, 4090, "latency"),
            ("wifi-11a-r34", 32, 2042, "throughput"), ("lte-tbcc", 64, 128, "throughput")):
        _, llrs, _ = codes_cell(name, n_frames, n_msg, 4.0, dev)
        arr = llrs.cpu().numpy()
        flushed = name != "lte-tbcc"
        reqs += [DecodeRequest(llrs=arr[i], code=name, slo=slo, flushed=flushed)
                 for i in range(n_frames)]
    _, chunks, _ = codes_cell("ccsds-k7", 1, 3 * 4096, 4.0, dev)
    chunks = chunks[0, :3 * 4096].cpu().numpy()

    def run(recorder):
        engine = make_decode_engine(device=dev, max_batch=64, recorder=recorder)
        tickets = [engine.submit(r, now=0.0) for r in reqs]
        sid = engine.open_session("ccsds-k7", now=0.0)
        for i in range(3):
            tickets.append(engine.submit_chunk(sid, chunks[i * 4096:(i + 1) * 4096],
                                               now=0.0))
            engine.drain(now=0.1 * (i + 1))
        engine.drain(now=1.0)
        return tickets

    off = run(NullRecorder())
    rec = SpanRecorder()
    zero_counts()
    on = run(rec)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    for a, b in zip(on, off, strict=True):
        if a.error or b.error or not np.array_equal(a.bits, b.bits):
            fail(f"profile: ticket {a.id} differs with the recorder on ({a.error}, {b.error})")
    spans = rec.find("engine.dispatch")
    worst = 0.0
    print(f"profile: {len(on)} tickets, bits identical with the recorder off; "
          f"{len(spans)} dispatch spans priced on {H100.name} (launches {got})", flush=True)
    for s in spans:
        a = s.attrs
        if "hbm_bytes_modeled" not in a or "achieved_hbm_frac" not in a:
            fail(f"profile: a dispatch span lacks the profile attributes: {a}")
        fracs = (a["achieved_hbm_frac"], a["achieved_flops_frac"])
        worst = max(worst, *fracs)
        print(f"  {a['code']}/{a['path']} f={a['f']} t={a['t']}: modelled "
              f"{a['hbm_bytes_modeled']} B, {a['flops_modeled']:.6e} operations, depth "
              f"{a['depth_modeled']}, {a['bottleneck']}-bound (t_memory {a['t_memory_us']} "
              f"us, t_compute {a['t_compute_us']} us); wall {a['wall_s'] * 1e3:.3f} ms: "
              f"achieved_hbm_frac {fracs[0]:.6e}, achieved_flops_frac {fracs[1]:.6e}",
              flush=True)
    if not {"batch", "time_parallel", "session", "wava"} <= {s.attrs["path"] for s in spans}:
        fail("profile: the engine run missed a route")
    if worst > 1.0:
        fail(f"profile: an achieved fraction reads {worst} > 1.0")
    return got


def verify_phase(dev):
    """Phase 14: verification and tooling on the card: the farm's smoke
    grid and its gate (``verify.farm.main``), the --full grid, each
    path's launches and integer-LLR kernel holds, the sharded farm, the
    parity main, the traffic report and the engine's profiled spans.
    Returns {run: {kernel: launches}} of the main-path runs."""
    from repro_torch.kernels import parity
    from repro_torch.verify import farm

    t_phase = time.perf_counter()
    launches = {}
    print("phase 14 (verify): the BER farm, its gate and the tooling on the card",
          flush=True)
    launches["farm smoke"], _ = verify_main("verify.farm", farm, [])
    for kernel in ("K1", "K2"):
        if not launches["farm smoke"].get(kernel):
            fail(f"the farm's smoke grid launched no {kernel}")
    full = ["--full", "--frames", str(VERIFY_FULL_FRAMES), "--frame-budget",
            str(VERIFY_BUDGET_STAGES), "--batch-frames", str(VERIFY_BATCH)]
    launches["farm --full"], lines = verify_main("verify.farm", farm, full)
    for kernel in ("K1", "K2", "K3"):
        if not launches["farm --full"].get(kernel):
            fail(f"the farm's --full grid launched no {kernel}")
    rows = [ln for ln in lines if "@ebn0=" in ln and not ln.startswith("gate")]
    print(f"farm --full: {len(rows)} points of {VERIFY_FULL_FRAMES} frames x "
          f"{VERIFY_BUDGET_STAGES} stages; the 2 dB rows:", flush=True)
    for ln in rows:
        if "@ebn0=2 " in ln:
            print(f"  {ln}")
    t0 = time.perf_counter()
    for path, counts in verify_paths(dev).items():
        launches[f"farm path {path}"] = counts
    print(f"farm paths took {time.perf_counter() - t0:.1f} s", flush=True)
    launches[f"farm on {VERIFY_SHARDS} shards"] = verify_sharded(dev)
    launches["kernels.parity"], _ = verify_main("kernels.parity", parity, [])
    verify_traffic(dev)
    launches["profile engine"] = verify_profile(dev)
    print(f"phase 14 (verify) took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {VERIFY_BUDGET_S} s)", flush=True)
    return launches


# -- phase 15: the LM testbed's serving path ----------------------------------

LM_BUDGET_S = 60  # phase 15's time budget, printed beside its seconds
LM_TOL = 1e-4  # rtol = atol: the card against the port's CPU run, f32 activations
LM_FORWARD_TOL = 1e-3  # teacher-forced decode against forward (the reference's test)
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_DEC = 2, 32, 4  # batch, prompt positions, decode steps
# the full-width runs: (arch, its one cut, batch, prompt tokens, greedy
# decode steps).  smollm-135m's is the slice's path; the others run the
# SSM, hybrid (past its 1,024-token window) and MoE families.  mixtral-8x7b
# at its 32 layers holds 47e9 f32 parameters, more than one 80 GB card: 2
# layers at full width (about 12 GB) is the one cut
LM_FULL = (
    ("smollm-135m", {}, 8, 4096, 64),
    ("mamba2-370m", {}, 4, 2048, 16),
    ("hymba-1.5b", {}, 2, 2048, 16),
    ("mixtral-8x7b", {"n_layers": 2}, 2, 512, 8),
)
LM_TIMED = 3  # timed prefills after the warm-up, median reported
LM_PROFILE_STEPS = 2  # smollm-135m decode steps under torch.profiler
LM_PROFILE_TOP = 6  # kernels by device time printed a profiled call
LM_SERVE = ("--service", "lm", "--arch", "smollm-135m", "--tokens", "8",
            "--streams", "4")


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def lm_err(got, want):
    """Largest |got - want| and whether every entry is within
    LM_TOL + LM_TOL * |want| (rtol = atol = LM_TOL)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = (got - want).abs()
    return float(err.max()), bool((err <= LM_TOL + LM_TOL * want.abs()).all())


def lm_smoke(arch, dev):
    """One smoke config at f32 activations, parameters from one seeded CPU
    generator: prefill of LM_SMOKE_B x LM_SMOKE_S positions and
    LM_SMOKE_DEC teacher-forced decode steps on the card against the same
    calls on the CPU (logits and every cache entry at LM_TOL); then on
    the card a prefill of the first LM_SMOKE_S - LM_SMOKE_DEC positions
    and LM_SMOKE_DEC decode steps against ``forward(mode="train")`` over
    LM_SMOKE_S positions, at LM_FORWARD_TOL."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(arch), activation_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    params = lm.init_params(cfg, gen, "cpu")
    B, S, n = LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_DEC
    s_tok = S - cfg.prefix_len
    tokens = torch.randint(0, cfg.vocab_size, (B, s_tok + n), generator=gen,
                           dtype=torch.int32)
    prefix = None
    if cfg.prefix_len:
        prefix = 0.02 * torch.randn((B, cfg.prefix_len, cfg.d_model), generator=gen)

    def run(device, p, n_prompt):
        px = None if prefix is None else prefix.to(device)
        cache = lm.init_cache(cfg, B, S + n, device)
        logits, cache = lm.prefill(p, cfg, tokens[:, :n_prompt].to(device), cache, px)
        out = [logits]
        for i in range(n):
            t = tokens[:, n_prompt + i:n_prompt + i + 1].to(device)
            logits, cache = lm.decode_step(p, cfg, t, cache)
            out.append(logits)
        return torch.stack(out), cache

    card_p = _tree_to(params, dev)
    want, want_cache = run(torch.device("cpu"), params, s_tok)
    got, got_cache = run(dev, card_p, s_tok)
    err, ok = lm_err(got, want)
    for key in want_cache:
        e, o = lm_err(got_cache[key], want_cache[key])
        err, ok = max(err, e), ok and o
    if not ok:
        fail(f"phase 15: {arch} smoke on the card differs from the CPU run by {err:.3e} "
             f"(rtol = atol = {LM_TOL})")
    full, _ = lm.forward(card_p, cfg, tokens[:, :s_tok].to(dev),
                         None if prefix is None else prefix.to(dev))
    steps, _ = run(dev, card_p, s_tok - n)
    fwd_err = float((steps.transpose(0, 1) - full[:, -n - 1:]).abs().max())
    if not torch.allclose(steps.transpose(0, 1), full[:, -n - 1:],
                          rtol=LM_FORWARD_TOL, atol=LM_FORWARD_TOL):
        fail(f"phase 15: {arch} smoke: teacher-forced decode differs from forward "
             f"by {fwd_err:.3e}")
    return {"shape": f"B={B} x {S} positions + {n} decode steps, f32",
            "max_abs_err": err, "forward_err": fwd_err, "check": "pass"}


def kernel_kind(name: str) -> str:
    """A CUDA kernel's kind from its name: a matmul (cuBLAS's gemm, gemv
    and Hopper ``nvjet`` kernels, or CUTLASS), a reduction, a copy or
    cast, another elementwise pass, or other."""
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if "reduce" in low:
        return "reduction"
    if "copy" in low:
        return "copy/cast"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def lm_profile(label, fn, reps, wall_ms):
    """Run ``fn`` ``reps`` times under ``torch.profiler`` and print, per
    call, the CUDA kernels launched and their summed device time, by kind
    and the longest by name; the device's busy share is that time over
    ``wall_ms``, the call's time measured without the profiler (one
    stream: the kernels do not overlap).  Only the CUDA activity is
    recorded: no host operator event is read, and a train step launches
    tens of thousands of kernels.  Returns that dict, with None where the
    profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:LM_PROFILE_TOP]
    kinds = {}
    for name, ms in by_name.items():
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + ms
    out = {"kernels": len(kernels) / reps, "wall_ms": wall_ms,
           "profiled_wall_ms": profiled_ms,
           "device_ms": device_ms if kernels else None,
           "busy": device_ms / wall_ms if kernels else None,
           "top": [[name[:160], ms] for name, ms in top], "by_kind_ms": kinds}
    if kernels:
        print(f"lm profile {label}: {out['kernels']:.1f} kernels a call, "
              f"{device_ms:.3f} ms of device time against {wall_ms:.3f} ms wall "
              f"unprofiled (busy {100 * out['busy']:.1f}%; {profiled_ms:.3f} ms "
              f"under the profiler), {reps} calls; by kind: "
              + ", ".join(f"{k} {100 * v / device_ms:.1f}%" for k, v in
                          sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)
        for name, ms in top:
            print(f"  {ms:.3f} ms ({100 * ms / device_ms:.1f}%) {name[:160]}")
    else:
        print(f"lm profile {label}: the profiler recorded no device time "
              f"(not measured)", flush=True)
    return out


def lm_full(arch, cut, B, S, steps, dev):
    """One full-width config at its default bf16 activations, parameters
    drawn on the card: prefill B x S through ``make_prefill_step`` (a
    warm-up, then LM_TIMED timed by CUDA events; the median), then
    ``steps`` greedy steps through ``make_decode_step`` on the host
    clock.  Fails on a non-finite logit or a token outside the logits'
    vocabulary (``padded_vocab``; smollm-135m's vocabulary is unpadded, so
    there that is its own; at random weights another arch may pick a
    padding id)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_config(arch), **cut)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init_params(cfg, gen, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - cfg.prefix_len),
                                     generator=gen, device=dev, dtype=torch.int32)}
    cache0 = lm.init_cache(cfg, B, S + steps, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    times = []
    for rep in range(1 + LM_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = prefill(params, cache0, batch)
        stop.record()
        stop.synchronize()
        if rep:
            times.append(start.elapsed_time(stop))
    prefill_ms = float(np.median(times))
    finite = torch.isfinite(logits).all()
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = decode(params, cache, nxt)
        finite &= torch.isfinite(logits).all()
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        out.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    peak = torch.cuda.max_memory_allocated()
    if not bool(finite):
        fail(f"phase 15: {arch} produced a non-finite logit")
    lo, hi = int(toks.min()), int(toks.max())
    if lo < 0 or hi >= cfg.padded_vocab:
        fail(f"phase 15: {arch} decoded a token outside [0, {cfg.padded_vocab})")
    if int(cache["pos"]) != S + steps:
        fail(f"phase 15: {arch}'s cache ends at position {int(cache['pos'])}, "
             f"not {S + steps}")
    tok_s = B * steps / decode_s
    cut_text = f", cut {cut}" if cut else ""
    print(f"lm {arch}: full width{cut_text}, {cfg.activation_dtype}, "
          f"{cfg.n_params() / 1e6:.1f}M parameters: prefill {B} x {S} in "
          f"{prefill_ms:.3f} ms (median of {LM_TIMED}: "
          f"{', '.join(f'{t:.3f}' for t in times)}), {steps} decode steps in "
          f"{decode_s * 1e3:.3f} ms = {tok_s:.1f} tok/s "
          f"({decode_s * 1e3 / steps:.3f} ms a step); peak memory {peak} bytes; "
          f"tokens in [{lo}, {hi}], finite", flush=True)
    return {"shape": f"B={B} x {S} prefill + {steps} decode steps, "
                     f"{cfg.activation_dtype}{cut_text}",
            "n_layers": cfg.n_layers, "prefill_ms": prefill_ms,
            "prefill_ms_each": times, "decode_ms": decode_s * 1e3,
            "decode_tok_s": tok_s, "peak_bytes": peak,
            "check": "finite, tokens in vocab"}


def lm_trace(dev, timed):
    """torch.profiler over the slice's path, after every timed run (the
    profiler slows what runs after it): smollm-135m at full width, one
    prefill and LM_PROFILE_STEPS decode steps, their busy shares taken
    against ``timed``, the unprofiled times of ``lm_full``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    arch, cut, B, S, steps = LM_FULL[0]
    cfg = dataclasses.replace(get_config(arch), **cut)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init_params(cfg, gen, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - cfg.prefix_len),
                                     generator=gen, device=dev, dtype=torch.int32)}
    cache0 = lm.init_cache(cfg, B, S + LM_PROFILE_STEPS, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    logits, cache = prefill(params, cache0, batch)
    state = {"cache": cache, "nxt": logits.argmax(-1)[:, None].to(torch.int32)}

    def step():
        logits, state["cache"] = decode(params, state["cache"], state["nxt"])
        state["nxt"] = logits.argmax(-1)[:, None].to(torch.int32)

    return {
        "prefill": lm_profile(f"{arch} prefill {B} x {S}",
                              lambda: prefill(params, cache0, batch), 1,
                              timed["prefill_ms"]),
        "decode_step": lm_profile(f"{arch} decode step", step, LM_PROFILE_STEPS,
                                  timed["decode_ms"] / steps),
    }


def lm_phase(dev):
    """Phase 15: the LM testbed's serving path on the card.  Returns the
    ``{"lm": ...}`` report."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import serve

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 15: TF32 is on")
    t_phase = time.perf_counter()
    print("phase 15 (lm): the LM testbed's prefill and decode on the card", flush=True)
    report = {"smoke": {}, "full": {}}
    for arch in ARCH_IDS:
        report["smoke"][arch] = lm_smoke(arch, dev)
    errs = [r["max_abs_err"] for r in report["smoke"].values()]
    fwd = [r["forward_err"] for r in report["smoke"].values()]
    print(f"lm smoke: {len(ARCH_IDS)} configs, card == CPU within {LM_TOL} (largest "
          f"|diff| {max(errs):.3e}), teacher-forced decode == forward within "
          f"{LM_FORWARD_TOL} (largest {max(fwd):.3e}); "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"lm card: {smi}", flush=True)
    for arch, cut, B, S, steps in LM_FULL:
        if cut:
            print(f"lm {arch}: the one cut of its config: {cut} (the full "
                  "depth does not fit one 80 GB card in f32)", flush=True)
        report["full"][arch] = lm_full(arch, cut, B, S, steps, dev)
    torch.cuda.empty_cache()
    rep = serve.main(list(LM_SERVE))
    if tuple(rep["tokens"].shape) != (4, 8) or not bool(torch.isfinite(rep["logits"]).all()):
        fail("phase 15: launch.serve --service lm returned a wrong report")
    report["serve"] = {"argv": " ".join(LM_SERVE), "tok_s": rep["tok_s"],
                       "seconds": rep["seconds"], "check": "exit 0, report line"}
    report["profile"] = lm_trace(dev, report["full"][LM_FULL[0][0]])
    report["card"] = smi
    report["seconds"] = time.perf_counter() - t_phase
    report["budget_s"] = LM_BUDGET_S
    print(f"phase 15 (lm) took {report['seconds']:.1f} s (budget {LM_BUDGET_S} s)",
          flush=True)
    return report


# -- phase 16: the LM testbed's training -------------------------------------

TRAIN_BUDGET_S = 60  # phase 16's time budget, printed beside its seconds
TRAIN_LOSS_RTOL = 1e-5  # the card's loss against the port's CPU run, f32
TRAIN_GRAD_TOL = 1e-4  # each gradient and moment leaf, of its largest magnitude
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)  # smoke steps
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 32  # smoke batch and positions
# the slice's path: smollm-135m at train_4k's sequence length of 4,096 and
# its global batch of 256 cut to 8 (the one cut), two microbatches, bf16
# activations, f32 parameters and optimiser state
TRAIN_FULL = ("smollm-135m", 256, 8, 4096, 2)  # arch, cell batch, batch, seq, microbatches
TRAIN_TIMED = 3  # timed steps after the warm-up, median reported
TRAIN_SSM = ("mamba2-370m", 4, 2048, 2)  # the SSD backward: arch, batch, seq, steps
TRAIN_DP_SHARDS, TRAIN_DP_STEPS = 4, 60  # the reference test's compressed DP run
TRAIN_RESUME = dict(steps=6, batch=2, seq_len=32, ckpt_interval=3, log_interval=100)
TRAIN_LAUNCH = ("--arch", "smollm-135m", "--smoke", "--steps", "20")


def train_leaf_errs(got, want):
    """Largest |got - want| over the leaves of two trees, as a fraction of
    each leaf's largest |want|; and the largest absolute difference."""
    from repro_torch.optim.adamw import tree_leaves

    rel = absolute = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        err = float((g - w).abs().max()) if g.numel() else 0.0
        rel = max(rel, err / max(float(w.abs().max()), 1e-30))
        absolute = max(absolute, err)
    return rel, absolute


def train_params_hold(got, want, grads, lr):
    """The contract's hold on new parameters: within 1e-3 x lr (+ 1e-6 x
    |p|) where the gradient is at least 1e-3 of its leaf's largest, within
    2 x lr elsewhere.  Returns (holds, largest difference over lr)."""
    from repro_torch.optim.adamw import tree_leaves

    ok, worst = True, 0.0
    for g, w, gr in zip(tree_leaves(got), tree_leaves(want), tree_leaves(grads)):
        g, w, gr = (t.detach().float().cpu() for t in (g, w, gr))
        err = (g - w).abs()
        slack = 1e-6 * w.abs()
        big = gr.abs() >= 1e-3 * gr.abs().max()
        ok &= bool((err <= 1e-3 * lr + slack)[big].all())
        ok &= bool((err <= 2 * lr + slack).all())
        worst = max(worst, float(err.max()) / lr)
    return ok, worst


def train_batch(cfg, B, S, gen, dev):
    """Tokens, next-token labels (the last masked) and a frontend arch's
    prefix embeddings, drawn from ``gen`` on the CPU and moved to ``dev``."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S - cfg.prefix_len), generator=gen,
                           dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.prefix_len:
        batch["prefix_embeds"] = 0.02 * torch.randn((B, cfg.prefix_len, cfg.d_model),
                                                    generator=gen)
    return {k: v.to(dev) for k, v in batch.items()}


def train_smoke(arch, dev):
    """One smoke config at f32 activations: loss, gradients and one AdamW
    step on the card against the same calls on the CPU.  On smollm-135m
    also remat on against off and two microbatches against one, on the
    card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train import step

    cfg = dataclasses.replace(get_smoke_config(arch), activation_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    params = step.lm.init_params(cfg, gen, "cpu")
    batch = train_batch(cfg, TRAIN_SMOKE_B * 2, TRAIN_SMOKE_S, gen, "cpu")
    opt = AdamWConfig(**TRAIN_OPT)

    def run(p, b, c=cfg):
        """The loss, the gradients and the AdamW step on them: what
        ``make_train_step`` does at one microbatch."""
        loss, _, grads = step._grad_fn(c)(p, b)
        new, state, stats = adamw_update(grads, adamw_init(p), p, opt)
        return loss, grads, new, state, {**stats, "loss": loss}

    card_p = _tree_to(params, dev)
    card_b = {k: v.to(dev) for k, v in batch.items()}
    w_loss, w_grads, w_new, w_state, w_m = run(params, batch)
    g_loss, g_grads, g_new, g_state, g_m = run(card_p, card_b)
    lr = float(w_m["lr"])
    loss_err = abs(float(g_loss) - float(w_loss)) / abs(float(w_loss))
    grad_err, _ = train_leaf_errs(g_grads, w_grads)
    m_err, _ = train_leaf_errs(g_state.m, w_state.m)
    held, p_err = train_params_hold(g_new, w_new, w_grads, lr)
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
            and m_err <= TRAIN_GRAD_TOL and held):
        fail(f"phase 16: {arch} smoke step on the card differs from the CPU run: loss "
             f"{loss_err:.3e}, grads {grad_err:.3e}, m {m_err:.3e}, params {p_err:.3e} lr")
    out = {"shape": f"B={TRAIN_SMOKE_B * 2} x {TRAIN_SMOKE_S}, f32", "loss_rel_err": loss_err,
           "grad_err": grad_err, "m_err": m_err, "param_err_lr": p_err, "check": "pass"}
    if arch == "smollm-135m":
        _, r_grads, *_ = run(card_p, card_b, c=dataclasses.replace(cfg, remat=False))
        remat_err, _ = train_leaf_errs(g_grads, r_grads)
        mb_new, mb_state, mb_m = step.make_train_step(cfg, opt, microbatches=2)(
            card_p, adamw_init(card_p), card_b)
        mb_err, _ = train_leaf_errs(mb_state.m, g_state.m)
        mb_held, mb_p = train_params_hold(mb_new, g_new, g_grads, lr)
        mb_loss = abs(float(mb_m["loss"]) - float(g_m["loss"])) / abs(float(g_m["loss"]))
        if remat_err > TRAIN_GRAD_TOL or mb_err > TRAIN_GRAD_TOL or not mb_held or \
                mb_loss > TRAIN_LOSS_RTOL:
            fail(f"phase 16: smollm-135m on the card: remat on/off grads {remat_err:.3e}, "
                 f"2 microbatches against 1: loss {mb_loss:.3e}, m {mb_err:.3e}, "
                 f"params {mb_p:.3e} lr")
        out.update(remat_grad_err=remat_err, microbatch_loss_err=mb_loss,
                   microbatch_m_err=mb_err, microbatch_param_err_lr=mb_p)
    return out


def train_bound_ms(cfg, B, S):
    """The step's least time at the bf16 peak: the matmuls (every weight
    but the embedding's gather, 2 operations a weight a token forward, 4
    backward, 2 more for the remat forward) and the attention over every
    chunk pair (Q K^T and P V, 4 B S^2 H hd forward, four times over)."""
    n_mm = cfg.n_params() - cfg.padded_vocab * cfg.d_model  # no embedding gather
    mm = (6 + 2 * cfg.remat) * n_mm * B * S
    attn = 4 * B * S * S * cfg.n_heads * cfg.head_dim_ * cfg.n_layers
    passes = 4 if cfg.remat else 3
    return (mm + attn * passes) / PEAK_BF16_FLOPS * 1e3, mm + attn * passes


def train_full_step(arch, B, S, microbatches, timed, dev, profile=False):
    """A full-width config at its bf16 activations, parameters drawn on the
    card: one warm-up step, then ``timed`` steps timed by CUDA events (the
    median); each step's loss read after it.  With ``profile``, one more
    step under ``torch.profiler``."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, opt_state = step.init_train_state(cfg, gen, dev)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=B, seq_len=S, seed=SEED,
                         device=dev)
    train_step = step.make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
    times, losses = [], []
    for i in range(1 + timed):
        batch = stream.batch_at(i)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        stop.record()
        stop.synchronize()
        losses.append(float(metrics["loss"]))
        if i:
            times.append(start.elapsed_time(stop))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"phase 16: {arch} gave a non-finite loss: {losses}")
    step_ms = float(np.median(times)) if times else None
    out = {"shape": f"B={B} x {S}, {microbatches} microbatches, {cfg.activation_dtype} "
                    f"activations, f32 params and optimiser", "n_params": cfg.n_params(),
           "losses": losses, "step_ms": step_ms, "step_ms_each": times,
           "tokens_s": B * S / step_ms * 1e3 if step_ms else None, "peak_bytes": peak}
    if profile:
        batch = stream.batch_at(1 + timed)
        holder = {"p": params, "o": opt_state}

        def one():
            holder["p"], holder["o"], _ = train_step(holder["p"], holder["o"], batch)

        out["profile"] = lm_profile(f"train {arch} step {B} x {S}", one, 1, step_ms)
    return out


def train_dp(dev):
    """The reference test's EF-int8 data-parallel least squares on
    TRAIN_DP_SHARDS logical shards of the card and of the CPU: losses,
    parameters and every shard's residual after each step held (rtol
    1e-4, atol 1e-5), and the last loss under 0.05 x the first."""
    from repro_torch.distributed.decoder import frame_mesh
    from repro_torch.optim import compress

    def run(device):
        mesh = frame_mesh(TRAIN_DP_SHARDS, device=device)
        rng = np.random.default_rng(0)
        W = torch.as_tensor(rng.normal(0, 1, (16, 1)), dtype=torch.float32, device=device)

        def loss_fn(params, batch):
            x, y = batch
            return torch.mean((x @ params["w"] - y) ** 2)

        params = {"w": torch.zeros((16, 1), device=device)}
        err = compress.init_residuals(params, mesh)
        dp_step = compress.make_dp_train_step_compressed(loss_fn, mesh, lr=0.1)
        losses, ws, errs = [], [], []
        for _ in range(TRAIN_DP_STEPS):
            x = torch.as_tensor(rng.normal(0, 1, (32, 16)), dtype=torch.float32,
                                device=device)
            params, err, loss = dp_step(params, err, (x, x @ W))
            losses.append(loss)
            ws.append(params["w"])
            errs.append(torch.stack([e["w"] for e in err]))
        return (torch.stack(losses).cpu(), torch.stack(ws).cpu(), torch.stack(errs).cpu())

    t0 = time.perf_counter()
    got = run(dev)
    card_s = time.perf_counter() - t0
    want = run(torch.device("cpu"))
    held = all(torch.allclose(g, w, rtol=1e-4, atol=1e-5) for g, w in zip(got, want))
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    first, last = float(got[0][0]), float(got[0][-1])
    shards_differ = float((got[2][0, 0] - got[2][0, 1]).abs().max())
    print(f"train dp: {TRAIN_DP_SHARDS} logical shards of the card, {TRAIN_DP_STEPS} "
          f"steps in {card_s:.2f} s: loss {first:.4f} -> {last:.3e}; card == CPU "
          f"(losses, params, residuals: largest |diff| {max(errs):.3e}); shard 0 "
          f"and 1 residuals differ by {shards_differ:.3e} after step 1", flush=True)
    if not held or not last < 0.05 * first:
        fail(f"phase 16: the compressed DP step: card against CPU {errs}, "
             f"loss {first} -> {last}")
    return {"shards": TRAIN_DP_SHARDS, "steps": TRAIN_DP_STEPS, "first_loss": first,
            "last_loss": last, "max_abs_err": max(errs), "seconds": card_s,
            "check": "card == CPU, last < 0.05 x first"}


def train_resume(dev):
    """The loop on the card, smollm-135m's smoke config: TRAIN_RESUME's
    steps straight against a run stopped at half and resumed through
    ``CheckpointManager`` (the reference test's rtol 2e-4, atol 2e-5)."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.loop import TrainLoopConfig, train

    cfg = get_smoke_config("smollm-135m")
    quiet = lambda *a: None  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        full = dict(TRAIN_RESUME)
        p1, _, _ = train(cfg, TrainLoopConfig(ckpt_dir=f"{tmp}/a", **full),
                         log_fn=quiet, device=dev)
        train(cfg, TrainLoopConfig(ckpt_dir=f"{tmp}/b", **dict(full, steps=full["steps"] // 2)),
              log_fn=quiet, device=dev)
        logs = []
        p2, o2, _ = train(cfg, TrainLoopConfig(ckpt_dir=f"{tmp}/b", **full),
                          log_fn=logs.append, device=dev)
    errs = [float((a.float() - b.float()).abs().max()) for a, b in
            zip(tree_leaves(p1), tree_leaves(p2))]
    held = all(torch.allclose(a.float(), b.float(), rtol=2e-4, atol=2e-5)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    resumed = [line for line in logs if "resumed" in line]
    print(f"train resume: {full['steps']} steps straight == {full['steps'] // 2} + "
          f"resume ({resumed[0] if resumed else 'NOT RESUMED'}), largest |diff| "
          f"{max(errs):.3e}", flush=True)
    if not held or not resumed or int(o2.step) != full["steps"]:
        fail(f"phase 16: the resumed run differs from the straight one ({max(errs)})")
    return {"steps": full["steps"], "max_abs_err": max(errs), "log": resumed[0],
            "check": "rtol 2e-4, atol 2e-5"}


def train_phase(dev):
    """Phase 16: the LM testbed's training on the card.  Returns the
    ``{"train": ...}`` report."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import train as launch_train

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 16: TF32 is on")
    t_phase = time.perf_counter()
    print("phase 16 (train): the LM testbed's train step, loop and launcher on the card",
          flush=True)
    zero_counts()
    report = {"smoke": {}, "part_seconds": {}}
    t_part = [t_phase]

    def part(name):
        now = time.perf_counter()
        report["part_seconds"][name] = now - t_part[0]
        t_part[0] = now

    for arch in ARCH_IDS:
        report["smoke"][arch] = train_smoke(arch, dev)
    sm = report["smoke"]
    print(f"train smoke: {len(ARCH_IDS)} configs at f32, one step each, card == CPU "
          f"(largest loss {max(r['loss_rel_err'] for r in sm.values()):.3e} rel, grads "
          f"{max(r['grad_err'] for r in sm.values()):.3e} of each leaf's largest, new "
          f"params {max(r['param_err_lr'] for r in sm.values()):.3e} lr); smollm remat "
          f"on/off {sm['smollm-135m']['remat_grad_err']:.3e}, 2 microbatches against 1 "
          f"{sm['smollm-135m']['microbatch_m_err']:.3e}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    part("smoke")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"train card: {smi}", flush=True)

    arch, cell_b, B, S, mb = TRAIN_FULL
    print(f"train {arch}: the one cut of train_4k: its global batch of {cell_b} to "
          f"{B} (sequence {S} kept)", flush=True)
    full = train_full_step(arch, B, S, mb, TRAIN_TIMED, dev, profile=True)
    bound_ms, ops = train_bound_ms(get_config(arch), B, S)
    full.update(bound_ms=bound_ms, bound_ops=ops)
    print(f"train {arch}: full width, {full['shape']}, {full['n_params']} parameters: "
          f"step {full['step_ms']:.3f} ms (median of {TRAIN_TIMED}: "
          f"{', '.join(f'{t:.3f}' for t in full['step_ms_each'])}), "
          f"{full['tokens_s']:.1f} tokens/s; losses "
          f"{', '.join(f'{x:.4f}' for x in full['losses'])}; peak memory "
          f"{full['peak_bytes']} bytes; bf16 bound {bound_ms:.3f} ms ({ops:.3e} "
          f"operations), the step at {bound_ms / full['step_ms']:.2%} of it", flush=True)
    report["full"] = {arch: full}
    part(f"{arch} (init, {1 + TRAIN_TIMED} steps, 1 profiled)")
    arch2, B2, S2, steps2 = TRAIN_SSM
    ssm = train_full_step(arch2, B2, S2, 1, steps2 - 1, dev)
    print(f"train {arch2}: full width, {ssm['shape']}, {ssm['n_params']} parameters: "
          f"{steps2} steps, losses {', '.join(f'{x:.4f}' for x in ssm['losses'])}, "
          f"timed step {ssm['step_ms']:.3f} ms, {ssm['tokens_s']:.1f} tokens/s; peak "
          f"memory {ssm['peak_bytes']} bytes", flush=True)
    report["full"][arch2] = ssm
    part(arch2)
    torch.cuda.empty_cache()
    report["dp"] = train_dp(dev)
    part("dp (card and CPU)")
    report["resume"] = train_resume(dev)
    part("resume")
    t0 = time.perf_counter()
    hist = launch_train.main(list(TRAIN_LAUNCH))
    launch_s = time.perf_counter() - t0
    if not hist or not hist[-1][1] < hist[0][1]:
        fail(f"phase 16: launch.train's last logged loss is not under its first: {hist}")
    print(f"train launch: launch.train {' '.join(TRAIN_LAUNCH)}: exit 0 in "
          f"{launch_s:.1f} s, loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}", flush=True)
    report["launch"] = {"argv": " ".join(TRAIN_LAUNCH), "history": hist,
                        "seconds": launch_s, "check": "exit 0, last loss < first"}
    part("launch")
    launched = launch_counts()
    if any(launched.values()):
        fail(f"phase 16 launched kernels of the decoder: {launched}")
    report["kernel_launches"] = launched
    report["card"] = smi
    report["seconds"] = time.perf_counter() - t_phase
    report["budget_s"] = TRAIN_BUDGET_S
    print(f"phase 16 (train) took {report['seconds']:.1f} s (budget {TRAIN_BUDGET_S} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in report["part_seconds"].items())
          + f"; K1-K3 launches in it: {launched}", flush=True)
    return report


# -- phase 17: the LM testbed's sharding and dry run ----------------------------

SHARD_BUDGET_S = 60  # phase 17's time budget, printed beside its seconds
SHARD_MESH = (2, 2)  # (data, model) logical shards of the card
SHARD_SMOKE_B, SHARD_SMOKE_S = 4, 32  # the reference test's batch
SHARD_FULL = ("smollm-135m", 8, 4096)  # arch, batch, sequence at full width
SHARD_DECODE = 16  # greedy decode steps after the sharded prefill
SHARD_PIPE = (5, 4)  # pipeline stages (6 of smollm's 30 layers each), microbatches
SHARD_RESTORE = ((4, 1), (1, 1))  # meshes the (2, 2) train state restores onto
SHARD_RESTORE_B, SHARD_RESTORE_S = 4, 256  # the step after a restore
SHARD_BF16_ATOL = 0.1  # bf16 logits, the LM parity contract's loose bound
SHARD_TIE = 1e-3  # a greedy token may differ only where its top-2 logits are this close
SHARD_DRYRUN = ("--all", "--mesh", "both")
SHARD_DRYRUN_TIMEOUT_S = 600


def shard_train_holds(label, got, want, lr, bitwise):
    """A sharded step's (params, opt, metrics) against another step's: bit
    for bit where ``bitwise``, else phase 16's bounds (loss rtol 1e-5,
    first moments 1e-4 of each leaf's largest, new parameters as
    ``train_params_hold`` with the first moments for the gradients).
    Equality is read where the first tree lies; the bounds, only when
    the two differ, on the host."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim.adamw import tree_leaves

    def whole(tree):
        return shd.gather_tree(tree) if any(
            isinstance(x, shd.ShardedTensor) for x in shd._leaves(tree)) else tree

    g_p, g_m, w_p, w_m = whole(got[0]), whole(got[1].m), whole(want[0]), whole(want[1].m)
    g_loss, w_loss = float(got[2]["loss"]), float(want[2]["loss"])
    same = g_loss == w_loss and all(
        torch.equal(a, b.to(a.device)) for a, b in zip(
            tree_leaves(g_p) + tree_leaves(g_m), tree_leaves(w_p) + tree_leaves(w_m)))
    if same:
        return {"bitwise": True, "loss_rel_err": 0.0, "m_err": 0.0, "param_err_lr": 0.0}
    m_err, _ = train_leaf_errs(g_m, w_m)
    held, p_err = train_params_hold(g_p, w_p, w_m, lr)
    loss_err = abs(g_loss - w_loss) / abs(w_loss)
    if bitwise:
        fail(f"phase 17: {label}: not bit for bit (loss {loss_err:.3e}, m {m_err:.3e}, "
             f"params {p_err:.3e} lr)")
    if not (loss_err <= TRAIN_LOSS_RTOL and m_err <= TRAIN_GRAD_TOL and held):
        fail(f"phase 17: {label}: loss {loss_err:.3e}, m {m_err:.3e}, params {p_err:.3e} lr")
    return {"bitwise": False, "loss_rel_err": loss_err, "m_err": m_err,
            "param_err_lr": p_err}


def shard_smoke(arch, dev):
    """(a) One smoke config at f32: the sharded train step on a (2, 2) mesh
    of the card == the unsharded step on the card (2 microbatches; 1 on
    MoE) bit for bit, and == the sharded step on the CPU at phase 16's
    bounds."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step

    cfg = dataclasses.replace(get_smoke_config(arch), activation_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    params = step.lm.init_params(cfg, gen, "cpu")
    batch = train_batch(cfg, SHARD_SMOKE_B, SHARD_SMOKE_S, gen, "cpu")
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)  # every label counts
    opt = AdamWConfig(**TRAIN_OPT)
    out = {}
    runs = {}
    for where in ("cpu", dev):
        mesh = make_test_mesh(SHARD_MESH, device=where)
        p = _tree_to(params, where)
        b = {k: v.to(where) for k, v in batch.items()}
        sharded = spmd.make_sharded_train_step(cfg, mesh, opt)(
            *spmd.shard_train_state(p, adamw_init(p), cfg, mesh), b)
        runs[str(where)] = sharded
        if where == dev:
            plain = step.make_train_step(cfg, opt, microbatches=1 if cfg.n_experts else 2)(
                p, adamw_init(p), b)
            out["card_vs_unsharded"] = shard_train_holds(
                f"{arch} sharded on the card against unsharded", sharded, plain,
                float(plain[2]["lr"]), bitwise=True)
    out["card_vs_cpu"] = shard_train_holds(
        f"{arch} sharded on the card against the CPU", runs[str(dev)], runs["cpu"],
        float(runs["cpu"][2]["lr"]), bitwise=False)
    return out


def shard_full_train(dev):
    """(b) smollm-135m at full width, 8 x 4,096, bf16, on the (2, 2) mesh: a
    warm-up and a timed sharded step held to the unsharded step with 2
    microbatches from the same state.  Returns the report and the state
    after the timed step (for (e))."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import collective_wire_bytes
    from repro_torch.train import step

    arch, B, S = SHARD_FULL
    cfg = get_config(arch)
    mesh = make_test_mesh(SHARD_MESH)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, opt_state = step.init_train_state(cfg, gen, dev)
    sp, so = spmd.shard_train_state(params, opt_state, cfg, mesh)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=B, seq_len=S, seed=SEED,
                         device=dev)
    opt = AdamWConfig()
    sharded = spmd.make_sharded_train_step(cfg, mesh, opt)
    sp, so, warm = sharded(sp, so, stream.batch_at(0))
    # the unsharded step from the same state: the pieces put together
    p1 = shd.gather_tree(sp)
    o1 = type(so)(shd.gather(so.step), shd.gather_tree(so.m), shd.gather_tree(so.v))
    batch = stream.batch_at(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with shd.collective_log() as log:
        start.record()
        got = sharded(sp, so, batch)
        stop.record()
        stop.synchronize()
    step_ms = start.elapsed_time(stop)
    peak = torch.cuda.max_memory_allocated()
    want = step.make_train_step(cfg, opt, microbatches=2)(p1, o1, batch)
    del p1, o1
    hold = shard_train_holds(f"{arch} {B} x {S} sharded against 2 microbatches", got,
                             want, float(want[2]["lr"]), bitwise=False)
    del want
    losses = [float(warm["loss"]), float(got[2]["loss"])]
    if not all(np.isfinite(losses)):
        fail(f"phase 17: {arch} gave a non-finite loss: {losses}")
    kinds = {}
    for r in log:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    out = {"shape": f"B={B} x {S}, bf16 activations, mesh {SHARD_MESH} (data, model)",
           "step_ms": step_ms, "tokens_s": B * S / step_ms * 1e3, "losses": losses,
           "peak_bytes": peak, "state_bytes_shard0": spmd.shard_bytes(got[0])
           + spmd.shard_bytes(got[1]), "collectives": kinds,
           "wire_bytes": collective_wire_bytes(log), **hold}
    return out, (cfg, got[0], got[1])


def shard_full_serve(dev):
    """(c) smollm-135m at full width: sharded prefill of 8 x 4,096 and
    SHARD_DECODE greedy decode steps with the context-parallel cache (3
    kv heads do not divide "model" = 2: the sequence is cut), against
    the unsharded path fed the same tokens.  Tokens equal wherever the
    unsharded logits' top two are more than SHARD_TIE apart; logits
    within SHARD_BF16_ATOL."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm

    arch, B, S = SHARD_FULL
    cfg = get_config(arch)
    mesh = make_test_mesh(SHARD_MESH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = lm.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    cache = lm.init_cache(cfg, B, S + SHARD_DECODE, dev)
    sp = spmd.shard_params(params, cfg, mesh)
    sc = spmd.shard_cache(cache, cfg, mesh)
    seq_spec = sc["k"].spec[2]
    prefill, decode = spmd.make_sharded_prefill_step(cfg, mesh), spmd.make_sharded_decode_step(
        cfg, mesh)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got_l, got_c = prefill(sp, sc, {"tokens": tokens})
    stop.record()
    stop.synchronize()
    prefill_ms = start.elapsed_time(stop)
    want_l, want_c = lm.prefill(params, cfg, tokens, cache)
    err, ties, same = 0.0, 0, True
    t0 = time.perf_counter()
    for i in range(SHARD_DECODE + 1):
        err = max(err, float((got_l - want_l).abs().max()))
        top2 = want_l.topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= SHARD_TIE
        differ = got_l.argmax(-1) != want_l.argmax(-1)
        ties += int(near.sum())
        same &= not bool(differ.any())
        if bool((differ & ~near).any()):
            fail(f"phase 17: sharded {arch} decode step {i}: a greedy token differs from "
                 "the unsharded path away from a near tie")
        if i == SHARD_DECODE:
            break
        nxt = want_l.argmax(-1)[:, None].to(torch.int32)  # both fed the same tokens
        got_l, got_c = decode(sp, got_c, nxt)
        want_l, want_c = lm.decode_step(params, cfg, nxt, want_c)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if err > SHARD_BF16_ATOL:
        fail(f"phase 17: sharded {arch} logits differ from the unsharded path by {err:.3e}")
    return {"shape": f"prefill B={B} x {S} + {SHARD_DECODE} decode steps, bf16",
            "cache_seq_spec": str(seq_spec), "prefill_ms": prefill_ms,
            "decode_s_both_paths": decode_s, "logit_max_abs_err": err,
            "tokens_equal": same, "near_ties": ties}


def shard_pipeline(dev):
    """(d) smollm-135m's 30 layers in SHARD_PIPE[0] stages on a ("pipe",)
    mesh of the card, 8 x 4,096 bf16, SHARD_PIPE[1] microbatches, the
    layers' train-mode forward: equal bit for bit to the sequential stack
    run a microbatch at a time; the whole batch's stack within
    SHARD_BF16_ATOL."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm

    arch, B, S = SHARD_FULL
    n_stages, n_mb = SHARD_PIPE
    cfg = get_config(arch)
    per = cfg.n_layers // n_stages
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    params = lm.init_params(cfg, gen, dev)

    def split(node):
        return {k: split(v) for k, v in node.items()} if isinstance(node, dict) else \
            node.reshape((n_stages, per) + tuple(node.shape[1:]))

    stages = split(params["layers"])
    rope = lm._rope_tables(cfg, torch.arange(S, device=dev))
    x = 0.02 * torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)

    def stage_fn(stage_params, h):
        return lm._stack({"layers": stage_params}, cfg, h, rope, "train", {}, 0)[0]

    mesh = make_test_mesh((n_stages,), ("pipe",))
    apply = pipeline_apply(stage_fn, mesh, n_mb)
    with torch.no_grad():
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = apply(stages, x)
        stop.record()
        stop.synchronize()
        pipe_ms = start.elapsed_time(stop)
        per_mb = torch.cat([lm._stack(params, cfg, mb, rope, "train", {}, 0)[0]
                            for mb in x.split(B // n_mb)])
        whole = lm._stack(params, cfg, x, rope, "train", {}, 0)[0]
    if not torch.equal(got, per_mb):
        fail("phase 17: the pipeline differs from the sequential stack a microbatch at a time")
    err = float((got.float() - whole.float()).abs().max())
    if err > SHARD_BF16_ATOL:
        fail(f"phase 17: the pipeline differs from the whole batch's stack by {err:.3e}")
    return {"shape": f"B={B} x {S}, {n_stages} stages of {per} layers, {n_mb} microbatches",
            "ms": pipe_ms, "bubble_fraction": bubble_fraction(n_stages, n_mb),
            "max_abs_err_whole_batch": err, "check": "== sequential per microbatch"}


def shard_restore(state, dev):
    """(e) The (2, 2) train state of (b) saved, restored onto each of
    SHARD_RESTORE bit for bit, and one step there from the restored state
    == one step from the saved state laid out there directly."""
    import tempfile

    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig, OptState, tree_leaves
    from repro_torch.runtime import checkpoint

    cfg, sp, so = state
    batch = TokenStream(vocab_size=cfg.vocab_size, batch=SHARD_RESTORE_B,
                        seq_len=SHARD_RESTORE_S, seed=SEED + 3, device=dev).batch_at(0)
    plain_p = shd.gather_tree(sp)
    plain_o = OptState(shd.gather(so.step), shd.gather_tree(so.m), shd.gather_tree(so.v))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save(tmp, 1, {"params": sp, "opt": so})
        out["save_s"] = time.perf_counter() - t0
        for shape in SHARD_RESTORE:
            mesh = make_test_mesh(shape)
            p_sh, o_sh = shd.train_state_shardings(cfg, mesh, plain_p, None)
            t0 = time.perf_counter()
            got = checkpoint.restore(tmp, 1, {"params": sp, "opt": so},
                                     shardings={"params": p_sh, "opt": o_sh})
            restore_s = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(shd.gather_tree(got["params"])) + tree_leaves(
                    shd.gather_tree(got["opt"].m)) + tree_leaves(shd.gather_tree(got["opt"].v)),
                tree_leaves(plain_p) + tree_leaves(plain_o.m) + tree_leaves(plain_o.v)))
            if not same or int(shd.gather(got["opt"].step)) != int(plain_o.step):
                fail(f"phase 17: the train state restored onto {shape} differs from the saved one")
            step = spmd.make_sharded_train_step(cfg, mesh, AdamWConfig())
            after = step(got["params"], got["opt"], batch)
            direct = step(*spmd.shard_train_state(plain_p, plain_o, cfg, mesh), batch)
            shard_train_holds(f"one step after the restore onto {shape}", after, direct,
                              float(direct[2]["lr"]), bitwise=True)
            out[str(shape)] = {"restore_s": restore_s, "check": "bit for bit"}
    return out


def shard_phase(dev):
    """Phase 17: the LM testbed's sharding on logical meshes of the card and
    the dry run on ``meta`` (started first, in worker processes, and
    waited for last).  Returns the ``{"shard": ...}`` report."""
    import os
    import tempfile

    from repro_torch.configs import ARCH_IDS

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 17: TF32 is on")
    t_phase = time.perf_counter()
    print("phase 17 (shard): the LM testbed's sharding on logical meshes of the card and "
          "the dry run", flush=True)
    zero_counts()
    report = {"part_seconds": {}}
    t_part = [t_phase]

    def part(name):
        now = time.perf_counter()
        report["part_seconds"][name] = now - t_part[0]
        t_part[0] = now

    out_dir = tempfile.TemporaryDirectory()
    jobs = max(1, min(6, (os.cpu_count() or 2) - 2))
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *SHARD_DRYRUN,
            "--jobs", str(jobs), "--out", out_dir.name]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    dry = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, env=env)
    try:
        report["smoke"] = {arch: shard_smoke(arch, dev) for arch in ARCH_IDS}
        sm = report["smoke"]
        print(f"shard smoke: {len(ARCH_IDS)} configs at f32 on a {SHARD_MESH} mesh of the "
              f"card: sharded == unsharded bit for bit; against the CPU's sharded step "
              f"loss {max(r['card_vs_cpu']['loss_rel_err'] for r in sm.values()):.3e} rel, "
              f"m {max(r['card_vs_cpu']['m_err'] for r in sm.values()):.3e}, params "
              f"{max(r['card_vs_cpu']['param_err_lr'] for r in sm.values()):.3e} lr", flush=True)
        part("smoke")
        full, state = shard_full_train(dev)
        print(f"shard train {SHARD_FULL[0]}: {full['shape']}: step {full['step_ms']:.3f} ms, "
              f"{full['tokens_s']:.1f} tokens/s, losses "
              f"{', '.join(f'{x:.4f}' for x in full['losses'])}; peak memory "
              f"{full['peak_bytes']} bytes; shard 0's state {full['state_bytes_shard0']} bytes; "
              f"collectives {full['collectives']}, wire bytes {full['wire_bytes']:.0f}; "
              f"against 2 microbatches unsharded: bit for bit {full['bitwise']}, loss "
              f"{full['loss_rel_err']:.3e}, m {full['m_err']:.3e}", flush=True)
        report["train"] = full
        part("train")
        report["restore"] = shard_restore(state, dev)
        del state
        print(f"shard restore: saved from {SHARD_MESH}, restored onto "
              f"{', '.join(map(str, SHARD_RESTORE))} bit for bit; one step after each == one "
              f"step before ({report['restore']})", flush=True)
        part("restore")
        torch.cuda.empty_cache()
        report["serve"] = shard_full_serve(dev)
        sv = report["serve"]
        print(f"shard serve {SHARD_FULL[0]}: {sv['shape']}, cache sequence over "
              f"{sv['cache_seq_spec']}: prefill {sv['prefill_ms']:.3f} ms; tokens equal "
              f"{sv['tokens_equal']} ({sv['near_ties']} near ties), logits within "
              f"{sv['logit_max_abs_err']:.3e}", flush=True)
        part("serve")
        torch.cuda.empty_cache()
        report["pipeline"] = shard_pipeline(dev)
        pp = report["pipeline"]
        print(f"shard pipeline: {pp['shape']}: {pp['ms']:.3f} ms, bubble fraction "
              f"{pp['bubble_fraction']:.4f}; {pp['check']}, whole batch within "
              f"{pp['max_abs_err_whole_batch']:.3e}", flush=True)
        part("pipeline")
        t0 = time.perf_counter()
        text, _ = dry.communicate(timeout=SHARD_DRYRUN_TIMEOUT_S)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    summary = [ln for ln in text.splitlines() if ln.startswith("== dry-run:")]
    if dry.returncode != 0 or not summary:
        print(text[-4000:], flush=True)
        fail(f"phase 17: launch.dryrun {' '.join(SHARD_DRYRUN)} exited {dry.returncode}")
    rec_path = Path(out_dir.name) / "1pod-16x16" / "smollm-135m__train_4k.json"
    row = json.loads(rec_path.read_text())
    out_dir.cleanup()
    report["dryrun"] = {
        "argv": " ".join(SHARD_DRYRUN) + f" --jobs {jobs}", "summary": summary[0],
        "wait_s": time.perf_counter() - t0, "seconds_since_phase_start":
        time.perf_counter() - t_phase,
        "smollm_train_4k": {k: row[k] for k in (
            "flops_per_device", "hbm_bytes_per_device", "wire_bytes_per_device",
            "t_compute", "t_memory", "t_collective", "bottleneck", "mfu_bound",
            "memory_stats", "collective_counts")}}
    r = report["dryrun"]["smollm_train_4k"]
    print(f"shard dryrun: launch.dryrun {report['dryrun']['argv']} on meta: "
          f"{summary[0].strip('= ')}; waited {report['dryrun']['wait_s']:.1f} s at the end; "
          f"smollm-135m train_4k on 1pod-16x16 (roofline.H100): compute {r['t_compute']:.6f} s, "
          f"memory {r['t_memory']:.6f} s, collective {r['t_collective']:.6f} s, bottleneck "
          f"{r['bottleneck']}, shard state {r['memory_stats']['argument_bytes']} bytes",
          flush=True)
    part("dryrun (the wait)")
    launched = launch_counts()
    if any(launched.values()):
        fail(f"phase 17 launched kernels of the decoder: {launched}")
    report["kernel_launches"] = launched
    report["seconds"] = time.perf_counter() - t_phase
    report["budget_s"] = SHARD_BUDGET_S
    print(f"phase 17 (shard) took {report['seconds']:.1f} s (budget {SHARD_BUDGET_S} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in report["part_seconds"].items())
          + f"; K1-K3 launches in it: {launched}", flush=True)
    return report


def main() -> None:
    t_start = time.perf_counter()
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
    from repro_torch.core.decoder import _flush_step
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import acs_decode_fused_ref, acs_forward_ref

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
    with ThreadPoolExecutor(len(viterbi_acs.KERNELS)) as pool:
        libs = dict(zip(viterbi_acs.KERNELS,
                        pool.map(viterbi_acs.build, viterbi_acs.KERNELS)))
    print(f"build: {', '.join(p.name for p in libs.values())} "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for kernel, lib_path in libs.items():
        for line in ptxas_report(lib_path.with_suffix(".log").read_text()):
            print(f"  ptxas {kernel}: {line}")

    spec = CODE_K7_CCSDS
    tables = build_acs_tables(spec, 2)
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    w = torch.as_tensor(tables.fused_w, device=dev)
    # W's gather operands, made once as the decoder makes them: the timed
    # launches below read no W on the host
    operands = viterbi_acs.gather_operands(w, B, S, R)
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
    sweep_err, sweep_lp_err = shape_sweep_phase(dev)

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
    bits_plain = plain.decode_batch(quant[:8], time_parallel=False)
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
    k1_ms = cuda_ms(lambda: viterbi_acs.acs_forward(blocks, lam0, w, operands=operands,
                                                     **kw), reps=5)
    lam_k, phi_k = viterbi_acs.acs_forward(blocks, lam0, w, operands=operands, **kw)
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

    k1_bound, k1_bound_by = acs_bound(
        w, B, S, R, F_FULL * (N_FULL // 2), 1, True,
        blocks.numel() * 4 + lam0.numel() * 4 + w.numel() * 4
        + phi_k.numel() * phi_k.element_size() + lam_k.numel() * 4,
    )
    print(f"K1 bound: {k1_bound:.3f} ms ({k1_bound_by}); K1 at "
          f"{k1_bound / k1_ms:.2%} of it")
    del phi_k
    k1_row = {
        "name": "K1 acs_forward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acs_forward.cu",
        "replaces": "src/repro/kernels/viterbi_acs.py:172",
        "launches": launches,
        "max_abs_err": max(max_abs_err, sweep_err),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_bound_by,
        "library_ms": lib_ms,
    }

    # -- 5. K2 vs plain version -------------------------------------------
    k2_err = 0.0
    k2 = viterbi_acs.acs_decode_fused
    n_cols = operands.cols.shape[1]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = torch.randint(
        -8, 9, (T_SWEEP, F_SWEEP, B), generator=gen, device=dev
    ).float()
    lam0 = init_metric(F_SWEEP, S, 0, device=dev)

    def k2_case(label, blocks, lam0, hist0, **kw):
        nonlocal k2_err
        kw = dict(n_states=S, n_slots=R, k=spec.k, rho=2, **kw)
        got = k2(blocks, lam0, hist0, w, **kw)
        want = acs_decode_fused_ref(blocks, lam0, hist0, w, **kw)
        torch.cuda.synchronize()
        err = (got[1] - want[1]).abs().max().item()
        k2_err = max(k2_err, err)
        same = all(torch.equal(g, p) for g, p in zip(got, want))
        geo = viterbi_acs.k2_launch_geometry(
            S, R, B, n_cols, hist0.shape[0], kw["time_tile"],
            kw.get("pack_survivors", False), blocks.shape[1])
        waves = -(-geo["grid"] // (n_sms * geo["blocks_per_sm"]))
        print(f"K2 vs plain {label} (F={blocks.shape[1]} T={blocks.shape[0]} "
              f"D={hist0.shape[0]}; grid {geo['grid']} blocks of "
              f"{geo['block_frames']} frames, {geo['smem_bytes']} shared bytes a "
              f"block, rings in {'shared' if geo['rings_in_smem'] else 'device'} "
              f"memory, {geo['blocks_per_sm']} blocks an SM, {waves} "
              f"wave{'s' if waves > 1 else ''} on {n_sms} SMs): "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail(f"K2 differs from its plain version ({label}), "
                 f"max |lam| diff {err}")
        return waves

    for mm in (torch.float32, torch.bfloat16):
        for pack in (False, True):
            for renorm in (True, False):
                hist0 = k2_random_ring(gen, D_SWEEP, F_SWEEP, pack, dev)
                k2_case(f"mm={str(mm)[6:]} packed={pack} renorm={renorm}",
                        blocks, lam0, hist0, time_tile=TT_SWEEP,
                        matmul_dtype=mm, renorm=renorm, pack_survivors=pack)
    ragged = F_SWEEP - 3  # not a multiple of K2's 4 (or 3) frames a block
    k2_case("ragged F, packed", blocks[:, :ragged].contiguous(), lam0[:ragged],
            k2_random_ring(gen, D_SWEEP, ragged, True, dev),
            time_tile=TT_SWEEP, pack_survivors=True)
    k2_case("int8 ring of 2592 steps", blocks[:128].contiguous(), lam0,
            k2_random_ring(gen, 2560, F_SWEEP, False, dev),
            time_tile=TT_SWEEP, pack_survivors=False)
    k2_case("int8 ring of 4128 steps", blocks[:64].contiguous(), lam0,
            k2_random_ring(gen, 4096, F_SWEEP, False, dev),
            time_tile=TT_SWEEP, pack_survivors=False)
    # the geometry decode_stream_chunked launches in phase 6: its depth and
    # tile, the packed ring, F_FULL frames; four tiles
    d_main = decoder.decision_depth // 2
    tt_main = decoder._one_pass_tile(CHUNK_LEN // 2, d_main)
    waves = k2_case("streaming path's geometry, packed",
                    blocks[:4 * tt_main, :F_FULL].contiguous(), lam0[:F_FULL],
                    k2_random_ring(gen, d_main, F_FULL, True, dev),
                    time_tile=tt_main, pack_survivors=True)
    if waves != 1:
        fail(f"K2's grid at the streaming geometry takes {waves} waves, not one")
    hist0 = k2_random_ring(gen, D_SWEEP, F_SWEEP, True, dev)
    kw2 = dict(n_states=S, n_slots=R, k=spec.k, rho=2, time_tile=TT_SWEEP,
               pack_survivors=True)
    k2_sweep_ms = cuda_ms(lambda: k2(blocks, lam0, hist0, w, operands=operands, **kw2),
                          reps=3)
    k2_plain_ms = cuda_ms(
        lambda: acs_decode_fused_ref(blocks, lam0, hist0, w, **kw2),
        warmup=lambda: acs_decode_fused_ref(blocks[:TT_SWEEP], lam0, hist0, w, **kw2),
    )
    sweep_shape = (f"F={F_SWEEP} T={T_SWEEP} D={D_SWEEP} TT={TT_SWEEP} "
                   "f32 packed renorm")
    print(f"time K2 at {sweep_shape}: {k2_sweep_ms:.3f} ms; "
          f"plain version {k2_plain_ms:.3f} ms")

    # -- 6. stateful streaming at the decode_64k shape --------------------
    n_chunks = N_FULL // CHUNK_LEN
    viterbi_acs.acs_forward.launches = 0
    k2.launches = 0
    bits_s = decoder.decode_stream_chunked(llrs, chunk_len=CHUNK_LEN, initial_state=0)
    torch.cuda.synchronize()
    k2_launches, k1_in_stream = k2.launches, viterbi_acs.acs_forward.launches
    print(f"decode_stream_chunked: {n_chunks} chunks of {CHUNK_LEN} stages, "
          f"depth {decoder.decision_depth} stages, packed ring "
          f"{decoder.ring_packed}; K2 launches {k2_launches}, "
          f"K1 launches {k1_in_stream}")
    if k2_launches != n_chunks:
        fail(f"decode_stream_chunked launched K2 {k2_launches} times, "
             f"not once per chunk ({n_chunks})")
    if bits_s.shape != (F_FULL, N_FULL) or bits_s.device.type != "cuda":
        fail(f"decode_stream_chunked returned {tuple(bits_s.shape)} on {bits_s.device}")
    errors_s = int((bits_s[:, :n_info] != info).sum())
    ber_s = errors_s / (F_FULL * n_info)
    print(f"stream AWGN Eb/N0={EBN0_DB} dB: {errors_s} bit errors, BER "
          f"{ber_s:.3e} (limit {BER_LIMIT:g})")
    if not ber_s <= BER_LIMIT:
        fail(f"streaming BER {ber_s:.3e} above {BER_LIMIT:g}")
    if not torch.equal(bits_s, bits):
        fail("decode_stream_chunked and decode_batch decode the AWGN input "
             f"differently ({int((bits_s != bits).sum())} bits)")
    bits_sq = decoder.decode_stream_chunked(quant, chunk_len=CHUNK_LEN, initial_state=0)
    if not torch.equal(bits_sq, bits_q):
        fail("decode_stream_chunked and decode_batch decode the integer "
             f"LLRs differently ({int((bits_sq != bits_q).sum())} bits)")
    print("stream bits == decode_batch bits, on the AWGN and the integer LLRs")
    del bits_sq

    # K2 alone over the stream: the same 16 launches, state carried
    blocks_s = blocks_from_llrs(llrs, 2)
    tt = decoder._one_pass_tile(CHUNK_LEN // 2, decoder.decision_depth // 2)
    state0 = decoder.init_stream_state(F_FULL, initial_state=0)
    steps = CHUNK_LEN // 2
    chunk_blocks = [blocks_s[lo:lo + steps].contiguous()
                    for lo in range(0, N_FULL // 2, steps)]

    def k2_stream():
        lam, hist = state0.lam, state0.hist
        for cb in chunk_blocks:
            _, lam, hist = k2(cb, lam, hist, w, n_states=S, n_slots=R,
                              k=spec.k, rho=2, time_tile=tt,
                              pack_survivors=True, operands=operands)
        return lam, hist

    k2_stream_ms = cuda_ms(k2_stream)
    lam_end, hist_end = k2_stream()
    del chunk_blocks
    flush_ms = cuda_ms(lambda: _flush_step(hist_end, lam_end, tables, None))
    walls_s = sorted(
        host_ms(lambda: decoder.decode_stream_chunked(
            llrs, chunk_len=CHUNK_LEN, initial_state=0))[1]
        for _ in range(3)
    )
    wall_s = walls_s[1]
    mbps_s = F_FULL * N_FULL / wall_s / 1e3
    # the same call in its stages, each ending in a synchronize; the
    # validation is timed alone and again inside decode_chunk
    st = decoder.init_stream_state(F_FULL, initial_state=0)
    chunk_ms = validate_s_ms = 0.0
    outs = []
    for lo in range(0, N_FULL, CHUNK_LEN):
        part = llrs[:, lo:lo + CHUNK_LEN]
        validate_s_ms += host_ms(lambda: decoder._harden(part, where="stream"))[1]
        (st, out), ms = host_ms(lambda: decoder.decode_chunk(st, part))
        chunk_ms += ms
        outs.append(out)
    tail, flush_host_ms = host_ms(lambda: decoder.flush_stream(st))
    _, cat_ms = host_ms(lambda: torch.cat(outs + [tail], dim=1))
    del outs, tail, st
    two_pass = ViterbiDecoder.from_standard("ccsds-k7", one_pass=False)
    bits_2p, two_pass_ms = host_ms(lambda: two_pass.decode_stream_chunked(
        llrs, chunk_len=CHUNK_LEN, initial_state=0))
    print(f"time K2 over the stream ({n_chunks} launches of {steps} steps, "
          f"tile {tt}): {k2_stream_ms:.3f} ms "
          f"({k2_stream_ms / n_chunks:.3f} ms a launch)")
    print(f"time flush traceback ({decoder.decision_depth // 2} steps): "
          f"{flush_ms:.3f} ms")
    print(f"time decode_stream_chunked wall: {wall_s:.3f} ms (median of "
          f"{', '.join(f'{x:.3f}' for x in walls_s)}; K2 "
          f"{k2_stream_ms / wall_s:.1%}, flush {flush_ms / wall_s:.1%})")
    print(f"decode_stream_chunked stages (host clock): {n_chunks} decode_chunk "
          f"{chunk_ms:.3f} ms (validation alone {validate_s_ms:.3f} ms), "
          f"flush_stream {flush_host_ms:.3f} ms, concatenation {cat_ms:.3f} ms")
    print(f"stream decoded: {mbps_s:.3f} Mb/s")
    print(f"two-pass yardstick (one_pass=False, K1 + plain traceback per "
          f"chunk): {two_pass_ms:.3f} ms, "
          f"{F_FULL * N_FULL / two_pass_ms / 1e3:.3f} Mb/s; bits "
          f"{'==' if torch.equal(bits_2p, bits_s) else '!='} the one-pass bits")
    del bits_2p, bits_s
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # K2's bound over the stream: K1's ACS step with renorm (the sliding
    # traceback's integer work is not counted); bytes: LLRs in, bits out,
    # and each launch's entry and exit ring
    ring_bytes = hist_end.numel() * hist_end.element_size()
    k2_bound, k2_bound_by = acs_bound(
        w, B, S, R, F_FULL * (N_FULL // 2), 1, True,
        llrs.numel() * 4 + F_FULL * N_FULL  # int8 bits
        + n_chunks * 2 * ring_bytes + n_chunks * 2 * lam_end.numel() * 4,
    )
    print(f"K2 bound over the stream: {k2_bound:.3f} ms ({k2_bound_by}); "
          f"K2 at {k2_bound / k2_stream_ms:.2%} of it")
    del hist_end, blocks_s

    # -- 7. tiled streaming at the decode_1m stream length ----------------
    info_t = torch.randint(0, 2, (1, N_TILED), generator=gen, device=dev)
    sym_t = bpsk(conv_encode_torch(info_t, spec))
    stream = llr(awgn(gen, sym_t, EBN0_DB, spec.rate), EBN0_DB, spec.rate)[0]
    k2.launches = 0
    tiled = decoder.decode_stream_tiled(stream)
    torch.cuda.synchronize()
    tiled_launches = k2.launches
    tiled_2p = two_pass.decode_stream_tiled(stream)
    ber_t = (tiled != info_t[0]).float().mean().item()
    ber_t2 = (tiled_2p != info_t[0]).float().mean().item()
    print(f"decode_stream_tiled, 2^20 stages: K2 launches {tiled_launches}; "
          f"BER {ber_t:.3e} one-pass, {ber_t2:.3e} two-pass; "
          f"{int((tiled != tiled_2p).sum())} bits differ")
    if tiled_launches != 1 or tiled.shape != (N_TILED,):
        fail(f"decode_stream_tiled launched K2 {tiled_launches} times, "
             f"returned {tuple(tiled.shape)}")
    if not ber_t <= 1e-2:
        fail(f"tiled BER {ber_t:.3e}: the windows do not decode")
    cfg = decoder.default_tiled_config()
    n_win = N_TILED // cfg.frame_len
    padded = torch.nn.functional.pad(stream, (0, 0, cfg.overlap, cfg.overlap))
    idx = (torch.arange(n_win, device=dev)[:, None] * cfg.frame_len
           + torch.arange(cfg.window, device=dev)[None, :])
    wblocks = blocks_from_llrs(padded[idx], 2).contiguous()
    d_t = cfg.overlap // 2
    hist_t = torch.zeros((d_t, n_win, 4), dtype=torch.int32, device=dev)
    lam_t = init_metric(n_win, S, None, device=dev)
    tt_t = decoder._one_pass_tile(cfg.window // 2, d_t)
    k2_case(f"tiled windows, tile {tt_t}", wblocks, lam_t, hist_t,
            time_tile=tt_t, pack_survivors=True)
    del wblocks, padded, idx

    # -- 8. decode_chunk_multi: sessions at different positions ------------
    small = ViterbiDecoder.from_standard("ccsds-k7", decision_depth=512)
    a_llr, b_llr = quant[:2, :3072], quant[2:5, :2048]
    sa, _ = small.decode_chunk(small.init_stream_state(2, 0), a_llr[:, :1024])
    sb = small.init_stream_state(3, 0)
    k2.launches = 0
    for lo in (1024, 2048):
        ca, cb = a_llr[:, lo:lo + 1024], b_llr[:, lo - 1024:lo]
        (na, nb), (oa, ob) = small.decode_chunk_multi([sa, sb], [ca, cb])
        alone_a, want_a = small.decode_chunk(sa, ca)
        alone_b, want_b = small.decode_chunk(sb, cb)
        same = torch.equal(oa, want_a) and torch.equal(ob, want_b) and all(
            torch.equal(getattr(n, f), getattr(a, f))
            for n, a in ((na, alone_a), (nb, alone_b))
            for f in ("lam", "hist")
        ) and (na.pos, nb.pos) == (alone_a.pos, alone_b.pos)
        if not same:
            fail(f"decode_chunk_multi at positions {sa.pos}, {sb.pos} differs "
                 "from driving each session alone")
        sa, sb = na, nb
    if k2.launches < 2:
        fail("decode_chunk_multi did not run through K2")
    print(f"decode_chunk_multi: two sessions at positions 512 and 0 (steps) "
          f"emit what each emits alone, over 2 rounds (K2 launches {k2.launches})")

    k3_row = time_parallel_phase(decoder, llrs, gen, tables, w)
    logprob_rows = soft_phase(decoder, llrs, info, bits, quant, gen, tables, w,
                              sweep_lp_err)
    del llrs, quant, bits, info
    codes_launches, codes_err = codes_phase(dev)
    serve_launches, serve_err = serve_phase(dev)
    launcher_launches = launcher_phase(dev)
    verify_launches = verify_phase(dev)
    lm_report = lm_phase(dev)
    train_report = train_phase(dev)
    shard_report = shard_phase(dev)
    print(f"chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s")

    rows = [k1_row, {
        "name": "K2 acs_decode_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acs_decode_fused.cu",
        "replaces": "src/repro/kernels/viterbi_acs.py:421",
        "launches": k2_launches,
        "max_abs_err": max(k2_err, sweep_err),
        "ms": k2_stream_ms,
        "shape": f"decode_stream_chunked: F={F_FULL} x {N_FULL} stages, "
                 f"{n_chunks} launches of {steps} steps, D={decoder.decision_depth // 2}, TT={tt}",
        "plain_ms": k2_plain_ms,
        "plain_shape": sweep_shape,
        "ms_at_plain_shape": k2_sweep_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_bound_by,
        "library_ms": None,
    }, k3_row, *logprob_rows]
    # each kernel's launches on phase 11's paths, each its own main run,
    # on phase 12's routes in its clean run and on phase 13's launcher
    # runs, and its largest error there against its plain version
    for row in rows:
        kernel = row["name"].split()[0]
        row["codes_launches"] = {path: counts[kernel] for path, counts
                                 in codes_launches.items() if kernel in counts}
        row["serve_launches"] = {path: counts[kernel] for path, counts
                                 in serve_launches.items() if kernel in counts}
        row["launcher_launches"] = {run: counts[kernel] for run, counts
                                    in launcher_launches.items() if kernel in counts}
        row["verify_launches"] = {run: counts[kernel] for run, counts
                                  in verify_launches.items() if kernel in counts}
        row["max_abs_err"] = max(row["max_abs_err"], codes_err.get(kernel, 0.0),
                                 serve_err.get(kernel, 0.0))
    print(json.dumps({"lm": lm_report}))
    print(json.dumps({"train": train_report}))
    print(json.dumps({"shard": shard_report}, default=str))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
