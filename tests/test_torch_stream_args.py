"""The chunk arguments of the blocked ops and the span pipeline's helpers.

A chunk of a longer sequence passes its k-1 halo (blocked_codes,
aug_words), its successor's first byte (blocked_scored's next_valid,
block_rows_codes' first/next_byte) and its incoming carry
(compose_summaries_int64's x0, _top_blocks' x_in).  With them a chunk's
rows equal the same rows of the whole genome; without them (the default,
None or 0) every present caller is bit-identical to what it was before
the arguments existed: the fused, class and weight pipelines' outputs
hash to the values they had then.
"""

import hashlib

import numpy as np
import pytest
import torch

from kmer_spans_tpu_torch.ops.blocked import (
    block_rows_codes,
    blocked_codes,
    blocked_scan_summaries_int,
    blocked_scored,
    compose_summaries_int64,
)
from kmer_spans_tpu_torch.spans.finish import compose_summaries_exact
from kmer_spans_tpu_torch.spans.pipeline import (
    _top_blocks,
    aug_words,
    make_span_pipeline,
    make_weight_span_pipeline,
)

BLOCK = 512


def _genome(seed=3, n=8 * 4096):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[rng.random(n) < 0.004] = 4
    g[4090:4100] = 4  # an N run across the first chunk edge
    g[8192 - 3:8192 + 600] = np.tile(np.array([0, 3], np.uint8), 302)[:603]
    g[12288] = 4  # a chunk's first byte is N
    return torch.from_numpy(g)


def _tiles(x):
    nb = x.shape[0] // BLOCK
    return (x & 3).reshape(nb, BLOCK), (x < 4).reshape(nb, BLOCK)


@pytest.mark.parametrize("k", [1, 3, 8, 12])
def test_chunk_rows_equal_the_whole_genome(k):
    g = _genome()
    chunk, h = 4096, k - 1
    b2, v2 = _tiles(g)
    codes, kv = blocked_codes(b2, v2, k)
    scored = blocked_scored(v2, kv)
    aug = aug_words(g, k, BLOCK)[0] if 4 <= k <= 8 else None
    per = chunk // BLOCK
    for c in range(g.shape[0] // chunk):
        x = g[c * chunk:(c + 1) * chunk]
        halo = (g[c * chunk - h:c * chunk] if c else
                torch.full((h,), 4, dtype=torch.uint8))
        nxt = g[(c + 1) * chunk] if (c + 1) * chunk < g.shape[0] else None
        nv = None if nxt is None else nxt < 4
        cb2, cv2 = _tiles(x)
        cc, ckv = blocked_codes(cb2, cv2, k, first_bases=halo & 3,
                                first_valid=halo < 4)
        rows = slice(c * per, (c + 1) * per)
        assert torch.equal(cc, codes[rows]) and torch.equal(ckv, kv[rows])
        assert torch.equal(blocked_scored(cv2, ckv, next_valid=nv),
                           scored[rows])
        if aug is not None:
            ca, cs = aug_words(x, k, BLOCK, halo & 3, halo < 4, nv)
            assert torch.equal(ca, aug[rows])
            assert torch.equal(cs, scored[rows])
        idx = torch.tensor([0, per - 1, 3, 0])
        got = block_rows_codes(x, idx, k, BLOCK, first=halo,
                               next_byte=nxt)
        want = block_rows_codes(g, idx + c * per, k, BLOCK)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_defaults_are_the_genome_start_and_end():
    g = _genome()
    b2, v2 = _tiles(g)
    k = 6
    codes, kv = blocked_codes(b2, v2, k)
    four = torch.full((k - 1,), 4, dtype=torch.uint8)
    assert torch.equal(blocked_scored(v2, kv),
                       blocked_scored(v2, kv, next_valid=False))
    assert torch.equal(blocked_scored(v2, kv),
                       blocked_scored(v2, kv, next_valid=torch.tensor(False)))
    assert torch.equal(aug_words(g, k, BLOCK)[0],
                       aug_words(g, k, BLOCK, four & 3, four < 4, False)[0])
    idx = torch.tensor([0, 5, 63])
    for a, b in zip(block_rows_codes(g, idx, k, BLOCK),
                    block_rows_codes(g, idx, k, BLOCK, first=four,
                                     next_byte=torch.tensor(4))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("x0", [0, 1, 3000, (1 << 40) + 7])
def test_carry_composition_equals_the_host(x0):
    rng = np.random.default_rng(x0 % 97)
    s = torch.from_numpy(rng.integers(-3000, 1100, (64, BLOCK)).astype(
        np.int32))
    sc = torch.from_numpy(rng.random((64, BLOCK)) < 0.9)
    sc[7] = False  # a block with no scored position
    summ = blocked_scan_summaries_int(s, sc)
    got = compose_summaries_int64(*summ, x0=x0)
    want = compose_summaries_exact(*(t.numpy() for t in summ), x0=x0)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    if x0 == 0:
        for a, b in zip(got, compose_summaries_int64(*summ)):
            assert torch.equal(a, b)
        assert torch.equal(_top_blocks(*summ, 9), _top_blocks(*summ, 9, 0))
    top = _top_blocks(*summ, 9, x_in=x0)
    assert top.shape == (9,) and torch.equal(top, torch.sort(top).values)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()[:16]


def pipeline_digests() -> dict:
    """The fused (k = 8), class (k = 9) and weight (k = 8) pipelines'
    outputs on one seeded genome, hashed."""
    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, 48 * 4096).astype(np.uint8)
    g[rng.random(g.size) < 0.002] = 4
    for s in range(3000, g.size - 2000, 40_000):
        g[s:s + 1500] = np.tile(np.array([0, 3], np.uint8), 750)
    out = {}
    for k, block in ((8, 4096), (9, 4096), (9, 512)):
        fn = make_span_pipeline(k, block=block, cand_blocks=8, packed=True,
                                device="cpu")
        kind = "fused" if k == 8 else "class"
        out[f"{kind} k={k} block={block}"] = _digest(fn(g, 0.75))
    w_q = torch.from_numpy(rng.integers(-900, 700, 1 << 16).astype(np.int32))
    fn = make_weight_span_pipeline(8, block=4096, cand_blocks=8,
                                   with_scan_counts=True, device="cpu")
    res = fn(g, w_q)
    out["weight k=8"] = _digest(*(res[key] for key in sorted(res)))
    out["weight k=8 pull"] = _digest(*fn.pull(g, torch.tensor([0, 7, 47])))
    return out


def test_present_pipelines_are_unchanged():
    assert pipeline_digests() == {
        "fused k=8 block=4096": "2e0690abfd591cc2",
        "class k=9 block=4096": "15332bb44b78cf24",
        "class k=9 block=512": "1ba83b8104e03b79",
        "weight k=8": "753f21a0cf15f7ad",
        "weight k=8 pull": "90f1d6155ad8cdf5",
    }
