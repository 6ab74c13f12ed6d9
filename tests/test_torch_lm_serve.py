"""The LM serving path: ``serve.step``'s ``make_prefill_step`` and
``make_decode_step`` against the reference's ``lm.prefill`` and
``lm.decode_step`` (greedy tokens equal over 4 steps at f32
activations), and ``launch.serve --service lm`` on the CPU.

The reference side is built from ``lm.prefill``/``lm.decode_step``
directly: its ``launch/serve.py::serve_lm`` passes tokens and cache to
``decode_step`` the other way round and crashes (ROADMAP queue 3, R11).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lm import (
    assert_cache_close,
    assert_close,
    carried_params,
    inputs,
    jnp_or_none,
    ref_fns,
    smoke,
    t_or_none,
    to_numpy,
)

SERVE_ARCHS = ["smollm-135m", "internvl2-2b", "mamba2-370m", "mixtral-8x7b"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_step_factories_greedy_tokens_equal_the_reference(arch):
    from repro.models import lm as ref_lm

    from repro_torch.models import lm
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    ref_cfg, cfg = smoke(arch, activation_dtype="float32")
    ref_p, p = carried_params(ref_cfg)
    tokens, prefix = inputs(cfg, B=2, S=32, seed=1)
    _, pre, dec = ref_fns(ref_cfg)
    want_l, want_c = pre(ref_p, jnp.asarray(tokens), ref_lm.init_cache(ref_cfg, 2, 40),
                         jnp_or_none(prefix))
    batch = {"tokens": torch.as_tensor(tokens)}
    if prefix is not None:
        batch["prefix_embeds"] = t_or_none(prefix)
    prefill_step, decode_step = make_prefill_step(cfg), make_decode_step(cfg)
    got_l, got_c = prefill_step(p, lm.init_cache(cfg, 2, 40, device="cpu"), batch)
    assert_close(got_l, want_l, "prefill logits")
    want_t = np.asarray(jnp.argmax(want_l, -1))[:, None].astype(np.int32)
    got_t = got_l.argmax(-1)[:, None].to(torch.int32)
    for i in range(4):
        np.testing.assert_array_equal(got_t.numpy(), want_t, err_msg=f"step {i}")
        want_l, want_c = dec(ref_p, jnp.asarray(want_t), want_c)
        got_l, got_c = decode_step(p, got_c, got_t)  # (params, cache, tokens)
        assert_close(got_l, want_l, f"decode {i} logits")
        want_t = np.asarray(jnp.argmax(want_l, -1))[:, None].astype(np.int32)
        got_t = got_l.argmax(-1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert_cache_close(got_c, to_numpy(want_c), "after 4 steps")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_service_lm_main_on_the_cpu(arch, capsys):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve

    rep = serve.main(["--service", "lm", "--arch", arch, "--tokens", "3",
                      "--streams", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cfg = get_smoke_config(arch)
    assert re.fullmatch(
        rf"\[lm:{re.escape(cfg.name)}\] 3 tokens x 2 streams in \d+\.\d\ds "
        r"= \d+\.\d tok/s \(cpu, reduced config\)", line), line
    assert rep["cfg"] == cfg
    assert tuple(rep["tokens"].shape) == (2, 3)
    assert int(rep["tokens"].min()) >= 0 and int(rep["tokens"].max()) < cfg.padded_vocab
    assert tuple(rep["logits"].shape) == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(rep["logits"]).all())
