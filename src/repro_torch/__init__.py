"""repro_torch: the tensor-formulated Viterbi decoder (Mohammadidoost &
Hashemi, 2020) ported from JAX/Pallas on a TPU to PyTorch and CUDA on an
NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``repro/core/viterbi.py`` <-> ``repro_torch/core/viterbi.py``)
and never imports it, nor ``jax``.  Each Pallas TPU kernel becomes a
hand-written CUDA C++ kernel for ``sm_90a`` under ``kernels/csrc/``, with a
plain PyTorch version beside it that runs whenever the tensors lie on the
CPU.

Every module of ``repro`` has its counterpart here (the TPU-only names
aside):
  core     — trellis tables, encoder, channel, the matrix-form ACS scan,
             traceback, the time-parallel decode, soft output (BCJR and
             list-Viterbi), the BER harness and the ``ViterbiDecoder``
             front door (batch, tail-biting, tiled and chunked
             streaming, soft, sharded; punctured input on each)
  kernels  — K1, the fused ACS forward pass, K2, the one-pass
             ACS+traceback decode, and K3, the transfer-matrix formation
             (CUDA; K1 and K3 also at LOGPROB), with their plain
             versions; the parity gate and the traffic model
  codes    — the standard-code registry, puncturing, tail-biting (WAVA)
             decode and the end-to-end simulation
  configs  — the Viterbi service config and the LM testbed's ten archs
  data     — ``ChannelStream`` and the LM testbed's ``TokenStream``
  models   — the LM testbed's layers, SSD, MoE and ``lm``
  optim, train — AdamW, EF-int8 compression, the train step and loop
  obs      — the metrics registry, span tracing and the dispatch profile
  serve    — the multi-tenant ``DecodeEngine`` and the serve steps
  runtime  — chaos injection, failure detection, retry policy and
             checkpoints (sessions and train trees)
  verify   — the BER farm and gate, and the silent-data-corruption
             scrubber
  distributed — ``FrameMesh`` and the sharded decodes; the LM testbed's
             sharding rules, sharded steps and pipeline
  launch   — the serve and train launchers, meshes and the dry run
  roofline, hlocount — the H100 roofline and the operation counter
"""

__version__ = "0.1.0"
