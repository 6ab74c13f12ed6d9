"""The plain reference against brute force over every message of a tiny
trellis, and the generator's pieces against their definitions."""
import itertools
import math

import pytest
import torch

from portbench.reference import conv

K, POLYS = 3, (0o7, 0o5)  # the (2,1,3) code: 4 states


def _score(llrs, bits, k=K, polys=POLYS):
    coded = conv.encode(torch.tensor([bits]), k, polys)[0].to(torch.float64)
    return float(((1 - 2 * coded) * llrs).sum())


def _llrs(n, seed, beta=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, beta), generator=gen, dtype=torch.float64) * 3


def test_trellis_tables_follow_the_encoder():
    tr = conv.Trellis(7, (0o171, 0o133), 2)
    assert (tr.S, tr.R, tr.B, tr.cols.shape[1]) == (64, 4, 4, 16)
    # the super-branch p(j, r) -> j emits what the encoder emits from p
    for j in (0, 5, 37, 63):
        for r in range(4):
            p = ((j & 15) << 2) | r
            inputs = [(j >> 4) & 1, (j >> 5) & 1]
            history = [(p >> (5 - i)) & 1 for i in range(6)][::-1]  # oldest first
            coded = conv.encode(torch.tensor([history + inputs]), 7, (0o171, 0o133))[0, 6:]
            want = (1 - 2 * coded.to(torch.float64)).reshape(-1)
            assert torch.equal(tr.theta[:, j, r], want)


def test_encode_impulse_gives_the_generators():
    bits = torch.zeros((1, 10), dtype=torch.uint8)
    bits[0, 0] = 1
    coded = conv.encode(bits, 7, (0o171, 0o133))[0]
    for b, g in enumerate((0o171, 0o133)):
        taps = [(g >> (6 - d)) & 1 for d in range(7)]
        assert coded[:7, b].tolist() == taps


def test_puncture_round_trip():
    mask = [[1, 1], [0, 1], [0, 1], [0, 1], [1, 0], [0, 1], [1, 0]]
    x = torch.arange(2 * 14 * 2, dtype=torch.float32).reshape(2, 14, 2) + 1
    kept = conv.puncture(x, mask)
    assert kept.shape == (2, 16)
    back = conv.depuncture(kept, mask, 14)
    keep = torch.tensor(mask * 2, dtype=torch.bool)
    assert torch.equal(back[:, keep], x[:, keep]) and not back[:, ~keep].any()


@pytest.mark.parametrize("seed", range(4))
def test_ml_decode_and_path_gap_match_brute_force(seed):
    n = 8
    tr = conv.Trellis(K, POLYS, 2)
    llrs = _llrs(n, seed)
    scores = {m: _score(llrs, list(m)) for m in itertools.product((0, 1), repeat=n)}
    best = max(scores.values())
    bits = conv.viterbi_decode(llrs[None], tr, dtype=torch.float64)[0].tolist()
    assert math.isclose(scores[tuple(bits)], best, abs_tol=1e-9)
    for m in list(scores)[::17]:
        gap = conv.path_gap(llrs[None], torch.tensor([m]), tr, K)[0]
        assert math.isclose(float(gap), best - scores[m], abs_tol=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_window_decode_of_one_window_is_the_free_start_ml_path(seed):
    # one window over the whole block (no overlap, one tile) from a uniform
    # start: the best path over every start state and message
    n = 8
    tr = conv.Trellis(K, POLYS, 2)
    llrs = _llrs(n, 10 + seed)
    best, arg = -math.inf, None
    for start in itertools.product((0, 1), repeat=K - 1):
        for m in itertools.product((0, 1), repeat=n):
            s = _score(torch.cat([torch.zeros((K - 1, 2), dtype=torch.float64), llrs]),
                       list(start) + list(m))
            if s > best:
                best, arg = s, m
    got = conv.window_decode(llrs[None].float(), tr, n, 0, 0, None)[0]
    assert tuple(got.tolist()) == arg


@pytest.mark.parametrize("seed", range(3))
def test_bcjr_matches_brute_force_posteriors(seed):
    n = 6
    tr = conv.Trellis(K, POLYS, 2)
    llrs = _llrs(n, 20 + seed)
    msgs = list(itertools.product((0, 1), repeat=n))
    logp = torch.tensor([_score(llrs, list(m)) / 2 for m in msgs], dtype=torch.float64)
    want = []
    for i in range(n):
        zero = torch.tensor([m[i] == 0 for m in msgs])
        want.append(float(torch.logsumexp(logp[zero], 0) - torch.logsumexp(logp[~zero], 0)))
    got = conv.bcjr_llrs(llrs[None], tr, dtype=torch.float64)[0]
    assert torch.allclose(got.double(), torch.tensor(want, dtype=torch.float64), atol=1e-5)


def test_the_decision_plan_tiles_the_window():
    # a window of 8 steps, tiles of 2, depth 2: each decision point decides
    # the tile two steps behind it, and the centre's steps [2, 6) once; a
    # tile that does not divide the window is refused
    tr = conv.Trellis(K, POLYS, 2)
    llrs = _llrs(64, 5).float()[None]
    a = conv.window_decode(llrs, tr, frame_len=8, overlap=4, depth_steps=2, tile_steps=2)
    b = conv.window_decode(llrs, tr, frame_len=8, overlap=4, depth_steps=0, tile_steps=None)
    assert a.shape == b.shape == (1, 64)
    with pytest.raises(ValueError):
        conv.window_decode(llrs, tr, frame_len=8, overlap=4, depth_steps=2, tile_steps=3)
