"""The LM testbed's models: ``layers``, ``ssd`` (Mamba-2), ``moe`` and
``lm`` (init, cache, forward, prefill, decode), ports of the reference's
``models/`` package."""
