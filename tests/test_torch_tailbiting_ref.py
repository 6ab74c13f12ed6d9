"""The plain tail-biting maximum-likelihood decode (``tests/tbcc_reference.py``)
against brute force over every message, and the port's WAVA on
``lte-tbcc`` (the batch serve step, on the CPU) against it: equal where
the channel is good, never better than ML where it is not, and equal
wherever the best path of the open trellis is circular."""
import itertools
import math

import pytest
import torch

from tests.tbcc_reference import LTE_POLYS, encode_tailbiting, ml_decode, path_metric


def _channel(frames, n, ebn0_db, seed):
    """LLRs of random tail-biting blocks of ``lte-tbcc`` (rate 1/3): BPSK
    (bit 0 -> +1), white Gaussian noise at ``ebn0_db``, LLR 2y / sigma^2."""
    gen = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (frames, n), generator=gen)
    sigma = math.sqrt(1.0 / (2.0 * (1 / len(LTE_POLYS)) * 10.0 ** (ebn0_db / 10.0)))
    coded = encode_tailbiting(bits)
    y = (1.0 - 2.0 * coded.to(torch.float32)) + sigma * torch.randn(coded.shape, generator=gen)
    return (2.0 / sigma ** 2) * y


def _serve_step():
    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.serve.step import make_viterbi_serve_step

    return make_viterbi_serve_step(config_for_standard("lte-tbcc"), mode="batch", device="cpu")


@pytest.mark.parametrize("n", range(8, 13))
def test_ml_decode_is_the_best_of_every_message(n):
    llrs = _channel(12, n, 0.0, seed=n)  # noisy: the best message is often not the sent one
    messages = torch.tensor(list(itertools.product((0, 1), repeat=n)))
    signs = 1.0 - 2.0 * encode_tailbiting(messages).to(torch.float64)  # (M, n, 3)
    scores = torch.einsum("mnb,fnb->fm", signs, llrs.to(torch.float64))
    bits, metric, _ = ml_decode(llrs)
    assert torch.equal(bits.to(torch.int64), messages[scores.argmax(dim=1)])
    assert torch.allclose(metric, scores.amax(dim=1), rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_serve_step_returns_the_ml_bits_at_6db(seed):
    llrs = _channel(64, 64, 6.0, seed)
    out = _serve_step()(llrs)
    bits, _, _ = ml_decode(llrs)
    assert out.dtype == torch.int32 and torch.equal(out, bits)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wava_never_beats_ml_at_3db(seed):
    """WAVA checks only its best end state's path: where the best path of
    the open trellis is not circular it can keep a worse one, never a
    better one; where that path is circular it returns the ML path."""
    llrs = _channel(256, 64, 3.0, seed)
    out = _serve_step()(llrs)
    bits, metric, open_best = ml_decode(llrs, dtype=torch.float64)
    differ = (out != bits).any(dim=1)
    assert differ.any()  # at 3 dB some of 256 blocks depart
    assert bool((path_metric(llrs, out)[differ] <= metric[differ]).all())
    assert not differ[open_best].any()
