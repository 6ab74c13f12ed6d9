"""repro_torch: the tensor-formulated Viterbi decoder (Mohammadidoost &
Hashemi, 2020) ported from JAX/Pallas on a TPU to PyTorch and CUDA on an
NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``repro/core/viterbi.py`` <-> ``repro_torch/core/viterbi.py``)
and never imports it, nor ``jax``.  Each Pallas TPU kernel becomes a
hand-written CUDA C++ kernel for ``sm_90a`` under ``kernels/csrc/``, with a
plain PyTorch version beside it that runs whenever the tensors lie on the
CPU.

Subpackages ported so far:
  core     — trellis tables, encoder, channel, the matrix-form ACS scan,
             traceback, the time-parallel decode, soft output (BCJR and
             list-Viterbi), the BER harness and the ``ViterbiDecoder``
             front door (batch, tail-biting, tiled and chunked
             streaming, soft, sharded; punctured input on each)
  kernels  — K1, the fused ACS forward pass, K2, the one-pass
             ACS+traceback decode, and K3, the transfer-matrix formation
             (CUDA; K1 and K3 also at LOGPROB), with their plain versions
  codes    — the standard-code registry, puncturing, tail-biting (WAVA)
             decode and the end-to-end simulation
  data     — ``ChannelStream``, the seeded transmitter + channel batches
  obs      — the metrics registry and span tracing
  serve    — the multi-tenant ``DecodeEngine`` and ``make_decode_engine``
  runtime  — chaos injection, failure detection, retry policy and
             session-table checkpoints
  verify   — the online silent-data-corruption scrubber
  distributed — ``FrameMesh`` and the frame-sharded batch decode
"""

__version__ = "0.1.0"
