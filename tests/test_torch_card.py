"""The CUDA kernels of kmer_spans_tpu_torch against their plain versions, on
the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them.  The
file imports neither JAX nor tests/conftest.py, so it runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.oracle import golden_genome
from kmer_spans_tpu_torch.ops import gather, histogram, screen_scan
from kmer_spans_tpu_torch.ops.convert import to_tensor
from kmer_spans_tpu_torch.ops.gather import word_gather, word_gather_plain
from kmer_spans_tpu_torch.ops.histogram import (
    count_aug,
    count_aug_plain,
    histogram_plain,
)
from kmer_spans_tpu_torch.ops.screen_scan import (
    fused_screen_scan,
    fused_screen_scan_plain,
)
from kmer_spans_tpu_torch.spans.pipeline import make_span_pipeline
from kmer_spans_tpu_torch.spans.pm_pipeline import make_pm_span_pipeline
from kmer_spans_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda", 0)


def _aug_words(rng, n, k):
    codes = rng.integers(0, 1 << (2 * k), n).astype(np.int32)
    valid = rng.random(n) < 0.9
    scored = valid & (rng.random(n) < 0.8)
    return (codes | (valid.astype(np.int32) << 16)
            | (scored.astype(np.int32) << 17)).astype(np.int32)


@pytest.mark.parametrize("k", [4, 6, 8])
def test_count_aug_kernel_matches_plain(card, k):
    rng = np.random.default_rng(100 + k)
    aug = _aug_words(rng, (1 << 20) + 3, k)
    aug[5000:5000 + (1 << 17)] = (1 << 16) | 7  # 2^17 identical codes
    x = to_tensor(aug, card)
    before = histogram.count_aug_launches
    for view in (x, x[1:]):  # 16-byte aligned and unaligned starts
        got = count_aug(view, k)
        torch.cuda.synchronize()
        assert torch.equal(got, count_aug_plain(view, k))
    assert histogram.count_aug_launches == before + 2


@pytest.mark.parametrize("block", [256, 768, 1024, 3072, 8192, 16384, 32768])
@pytest.mark.parametrize("class_bits", [2, 4])
@pytest.mark.parametrize("k", [4, 8])
def test_screen_scan_kernel_matches_plain(card, k, class_bits, block):
    rng = np.random.default_rng(k + class_bits + block)
    nw = (1 << (2 * k)) // (32 // class_bits)  # 2^13 words at k = 8, 4-bit
    words = rng.integers(-(2 ** 31), 2 ** 31, nw, dtype=np.int64).astype(
        np.int32)
    # many blocks a persistent CTA; and fewer blocks than CTAs
    for nblocks in (max(6, (1 << 21) // block), 3):
        aug = _aug_words(rng, nblocks * block, k)
        aug[block:2 * block] &= ~(1 << 17)  # no scored position
        args = (to_tensor(words, card), to_tensor(aug, card),
                torch.tensor(3071, dtype=torch.int32, device=card),
                class_bits, block)
        before = screen_scan.launches
        got = fused_screen_scan(*args)
        torch.cuda.synchronize()
        assert screen_scan.launches == before + 1
        for g, w in zip(got, fused_screen_scan_plain(*args)):
            assert torch.equal(g, w)
        assert got[1][1].item() <= -(1 << 29)  # the no-scored sentinel


@pytest.mark.parametrize("n_words", [1, 32, 1 << 14])
def test_screen_scan_kernel_any_table(card, n_words):
    """Tables smaller and larger than the words a 16-bit code reaches."""
    rng = np.random.default_rng(n_words)
    words = rng.integers(-(2 ** 31), 2 ** 31, n_words,
                         dtype=np.int64).astype(np.int32)
    aug = _aug_words(rng, 64 * 8192, 8)
    for class_bits in (2, 4):
        args = (to_tensor(words, card), to_tensor(aug, card),
                torch.tensor(2866, dtype=torch.int32, device=card),
                class_bits, 8192)
        for g, w in zip(fused_screen_scan(*args),
                        fused_screen_scan_plain(*args)):
            assert torch.equal(g, w)


def test_screen_scan_refuses_misaligned_aug(card):
    words = torch.zeros(8192, dtype=torch.int32, device=card)
    aug = torch.zeros(4 * 1024 + 1, dtype=torch.int32, device=card)
    thr_q = torch.tensor(3000, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_screen_scan(words, aug[1:], thr_q, 4, 1024)


def test_wrappers_raise_on_mixed_devices(card):
    words = torch.zeros(512, dtype=torch.int32)
    aug = torch.zeros(2048, dtype=torch.int32, device=card)
    thr_q = torch.tensor(3000, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_screen_scan(words, aug, thr_q, 4, 1024)


@pytest.mark.parametrize("packed", [False, True])
def test_pipeline_kernels_match_plain_versions(card, packed, monkeypatch):
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 4, 64 * 8192).astype(np.uint8)
    arr[rng.random(arr.size) < 0.001] = 4
    arr[100_000:103_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    fn = make_span_pipeline(8, cand_blocks=16, packed=packed, device=card)
    before = histogram.count_aug_launches, screen_scan.launches
    got = fn(arr, 0.75)
    assert (histogram.count_aug_launches, screen_scan.launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(histogram, "count_aug", count_aug_plain)
    monkeypatch.setattr(screen_scan, "fused_screen_scan",
                        fused_screen_scan_plain)
    want = fn(arr, 0.75)
    if packed:
        assert torch.equal(got, want)
    else:
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_api_on_card_equals_cpu(card):
    seq = golden_genome()
    got = api.kmer_low_comp_regions(seq, 8, 100, 20.0, mode="fast",
                                    device=card)
    want = api.kmer_low_comp_regions(seq, 8, 100, 20.0, mode="fast",
                                     device="cpu")
    assert len(got.regions) == 3
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.counts, want.counts)


def test_fast_mode_on_a_fragmented_draft_equals_exact(card, monkeypatch):
    """chip_smoke.py's phase-4 draft check, the fast cell's path at a
    small size: mode="fast" at k = 8 and the source's span settings over
    2^22 bases in 168 contigs reruns on the card, launches K1 and K2 once
    a run, and returns exact mode's regions, counts and n, with w_rank the
    int64 rank mass over n (it raises otherwise)."""
    import chip_smoke
    from kmer_spans_tpu_torch.ops import window

    for mod, name in ((histogram, "count_aug_launches"),
                      (histogram, "histogram_launches"),
                      (screen_scan, "launches"), (gather, "launches"),
                      (window, "window_counts_launches")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    launches = chip_smoke.fast_draft_phase(card)
    assert launches["count_aug"] == launches["fused_screen_scan"] > 1


def test_api_overflow_reruns_on_card(card, monkeypatch):
    rng = np.random.default_rng(2)
    seq = rng.integers(0, 4, 40_000).astype(np.uint8)
    seq[9_000:9_800] = np.tile(np.array([3, 2], np.uint8), 400)
    seq[30_000:30_600] = 0
    packed = api._as_seq_list("".join("ACGT"[b] for b in seq))
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    got = api._low_comp_fast(packed, 6, 30, 3.0, 0.75, card, block=1024,
                             cand_blocks=1)
    assert api.exact_fallbacks >= 1
    want = api._low_comp_fast(packed, 6, 30, 3.0, 0.75, torch.device("cpu"),
                              block=1024)
    assert len(got.regions) >= 2
    assert np.array_equal(got.regions, want.regions)


@pytest.mark.parametrize("size", [1, 100, 256, 4096, 1 << 15, (1 << 15) + 1,
                                  65536, 1 << 18, (1 << 18) + 1, 1 << 19,
                                  1 << 20, 1 << 24])
def test_histogram_kernel_matches_plain(card, size):
    rng = np.random.default_rng(size)
    n = (1 << 20) + 3
    values = rng.integers(-3, size + 40, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    values[5000:5000 + (1 << 17)] = min(2, size - 1)  # 2^17 identical
    valid[5000:5000 + (1 << 17)] = True
    x, m = to_tensor(values, card), to_tensor(valid, card)
    before = histogram.histogram_launches
    # aligned; offset views aligned alike; offset views aligned unlike
    for args in ((x, m), (x[1:], m[1:]), (x[1:-1], m[2:]), (x[3:], m[:-3])):
        got = histogram.histogram(*args, size)
        torch.cuda.synchronize()
        assert torch.equal(got, histogram_plain(*args, size))
        for form in histogram.FORMS:  # every form, whatever the rule
            assert torch.equal(histogram.histogram_kernel(*args, size,
                                                          form),
                               histogram_plain(*args, size))
    assert not histogram.histogram(x, torch.zeros_like(m), size).any()
    assert histogram.histogram_launches == before + 5


@pytest.mark.parametrize("size", [1 << 20, 1 << 24])  # 4^10 and 4^12
def test_histogram_global_form_on_runs_of_equal_values(card, size):
    """Whole warps of one value, two values interleaved, a value at each
    end of the range, runs broken by invalid positions: one atomic per
    distinct value of a warp must still count every position."""
    rng = np.random.default_rng(size)
    n = (1 << 22) + 7
    values = rng.integers(0, size, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    values[1000:1000 + (1 << 20)] = 5                  # one value
    values[2_000_000:2_100_000:2] = size - 1           # two interleaved
    values[2_000_001:2_100_000:2] = 0
    valid[1000:1000 + (1 << 20)] = True
    valid[1500:1700] = False                           # a run broken
    values[3_000_000:3_000_100] = -2                   # out of range
    x, m = to_tensor(values, card), to_tensor(valid, card)
    for args in ((x, m), (x[1:], m[1:]), (x[3:], m[:-3])):
        for form in ("global", "partitioned"):
            got = histogram.histogram_kernel(*args, size, form)
            torch.cuda.synchronize()
            assert torch.equal(got, histogram_plain(*args, size)), form
    assert histogram.histogram_form(size) == "partitioned"


def _edge_values(rng, case, size, n):
    """Every value in one bin; all in one part (2^15 bins), spread over
    it; on part boundaries (2^15 j - 1, 2^15 j); half of them negative or
    >= size (chip_smoke.py edge_values)."""
    parts = -(-size // histogram.SLICE_BINS)
    valid = rng.random(n) < 0.9
    if case == "one bin":
        values = np.full(n, size // 3)
        valid[:] = True
    elif case == "one part":
        lo = parts // 2 * histogram.SLICE_BINS
        values = rng.integers(lo, min(size, lo + histogram.SLICE_BINS), n)
    elif case == "part edges":
        j = np.arange(parts + 1) * histogram.SLICE_BINS
        values = rng.choice(np.clip(np.concatenate([j - 1, j]), 0, size - 1),
                            n)
    else:
        values = rng.integers(0, size, n)
        out = rng.random(n) < 0.5
        values[out] = rng.choice([-1, -(2 ** 31), size, 2 ** 31 - 1],
                                 int(out.sum()))
    return values.astype(np.int32), valid


@pytest.mark.parametrize("case", ["one bin", "one part", "part edges",
                                  "out of range"])
@pytest.mark.parametrize("size", [1 << 16, 1 << 18, 1 << 24])
def test_histogram_edges_in_every_form(card, size, case):
    rng = np.random.default_rng(size + len(case))
    values, valid = _edge_values(rng, case, size, (1 << 20) + 3)
    x, m = to_tensor(values, card), to_tensor(valid, card)
    for args in ((x, m), (x[3:], m[:-3])):
        want = histogram_plain(*args, size)
        for form in histogram.FORMS:
            got = histogram.histogram_kernel(*args, size, form)
            torch.cuda.synchronize()
            assert torch.equal(got, want), form


@pytest.mark.parametrize("size", [1 << 26, 1 << 30])  # 4^13 and 4^15
def test_histogram_partitioned_at_the_largest_sizes(card, size):
    rng = np.random.default_rng(size % 1000)
    n = 1 << 22
    values = rng.integers(-3, size + 40, n).astype(np.int32)
    values[77:77 + (1 << 16)] = size - 1
    x, m = to_tensor(values, card), to_tensor(rng.random(n) < 0.8, card)
    want = histogram_plain(x, m, size)
    for form in ("partitioned", "global"):
        assert torch.equal(histogram.histogram_kernel(x, m, size, form),
                           want), form


@pytest.mark.parametrize("size", [1 << 18, 1 << 24])
def test_histogram_partitioned_walks_chunks(card, size, monkeypatch):
    """An input larger than the scratch cap goes in chunks that add into
    one output: a 4 MiB cap takes 2^22 positions in several."""
    monkeypatch.setattr(histogram, "PARTITION_SCRATCH_CAP", 4 << 20)
    rng = np.random.default_rng(size)
    n = (1 << 22) + 5
    plan = histogram.partition_plan(n, size, torch.cuda.get_device_properties(
        card).multi_processor_count)
    assert -(-n // plan.chunk) > 1
    values = rng.integers(-3, size + 40, n).astype(np.int32)
    values[9000:9000 + (1 << 17)] = size - 1
    x, m = to_tensor(values, card), to_tensor(rng.random(n) < 0.8, card)
    for args in ((x, m), (x[1:], m[1:]), (x[3:], m[:-3])):
        got = histogram.histogram_kernel(*args, size, "partitioned")
        torch.cuda.synchronize()
        assert torch.equal(got, histogram_plain(*args, size))


def test_histogram_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros(64, dtype=torch.int32, device=card)
    m = torch.ones(64, dtype=torch.bool, device=card)
    with pytest.raises(ValueError):  # not contiguous
        histogram.histogram(x[::2], m[::2], 10)
    with pytest.raises(ValueError):  # mixed devices
        histogram.histogram(x, m.cpu(), 10)
    with pytest.raises(TypeError):
        histogram.histogram(x, m.to(torch.uint8), 10)
    with pytest.raises(ValueError):
        histogram.histogram_kernel(x, m, 10, "shared")


@pytest.mark.parametrize("k", [12, 13, 15])
def test_pm_pipeline_kernel_matches_plain(card, k, monkeypatch):
    rng = np.random.default_rng(k)
    arr = rng.integers(0, 4, 64 * 8192).astype(np.uint8)
    arr[rng.random(arr.size) < 0.001] = 4
    arr[100_000:103_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    fn, _ = make_pm_span_pipeline(k, cand_blocks=16, device=card)
    before = histogram.histogram_launches
    got = fn(arr, 0.75)
    assert histogram.histogram_launches == before + 1
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    assert torch.equal(got, fn(arr, 0.75))


def test_api_k12_on_card_equals_cpu(card, monkeypatch):
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    seq = golden_genome()
    got = api.kmer_low_comp_regions(seq, 12, 100, 20.0, mode="fast",
                                    device=card)
    want = api.kmer_low_comp_regions(seq, 12, 100, 20.0, mode="fast",
                                     device="cpu")
    assert len(got.regions) == 3 and api.exact_fallbacks == 0
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.counts, want.counts)


@pytest.mark.parametrize("n_words", [2, 8, 8192, 16384, 32768])
def test_word_gather_kernel_matches_plain(card, n_words):
    rng = np.random.default_rng(n_words)
    words = to_tensor(rng.integers(-(2 ** 31), 2 ** 31, n_words,
                                   dtype=np.int64).astype(np.int32), card)
    thr_q = torch.tensor(3071, dtype=torch.int32, device=card)
    n = (1 << 20) + 3  # not a multiple of 4
    entry = rng.integers(0, 8 * n_words, n).astype(np.int32)
    entry[5000:5000 + (1 << 17)] = 8 * n_words - 3  # 2^17 identical
    entry[-4096:] = rng.integers(8 * n_words - 8, 8 * n_words, 4096)
    x = to_tensor(entry, card)
    before = gather.launches
    for view in (x, x[1:], x[2:-1]):  # aligned and unaligned starts
        got = word_gather(words, view, thr_q)
        torch.cuda.synchronize()
        assert torch.equal(got, word_gather_plain(words, view, thr_q))
    assert gather.launches == before + 3
    for bad in (1 << 16, 24):
        with pytest.raises(ValueError):
            word_gather(torch.zeros(bad, dtype=torch.int32, device=card), x,
                        thr_q)


def _planted(seed):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 4, 64 * 8192).astype(np.uint8)
    arr[rng.random(arr.size) < 0.001] = 4
    arr[100_000:103_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    return arr


@pytest.mark.parametrize("k,launches", [(9, (1, 1)), (12, (2, 1))])
def test_class_and_sort_pipelines_match_plain(card, k, launches,
                                               monkeypatch):
    """k = 9: the class screen (K3 once, K4); k = 12: the sort screen
    (K3 twice, K4)."""
    arr = _planted(k)
    fn = make_span_pipeline(k, cand_blocks=16, packed=True,
                            packed_counts=False, device=card)
    before = histogram.histogram_launches, gather.launches
    got = fn(arr, 0.75)
    assert (histogram.histogram_launches - before[0],
            gather.launches - before[1]) == launches
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    monkeypatch.setattr(gather, "word_gather", word_gather_plain)
    assert torch.equal(got, fn(arr, 0.75))


def test_api_k9_on_card_equals_cpu(card, monkeypatch):
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    seq = golden_genome()
    got = api.kmer_low_comp_regions(seq, 9, 100, 20.0, mode="fast",
                                    device=card)
    want = api.kmer_low_comp_regions(seq, 9, 100, 20.0, mode="fast",
                                     device="cpu")
    assert len(got.regions) == 3 and api.exact_fallbacks == 0
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.counts, want.counts)


# ------------------------------------------------------- the exact api path

def _exact_genome(seed, n=300_000):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 4, n).astype(np.uint8)
    arr[rng.random(n) < 0.001] = 4
    arr[40_000:43_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    arr[200_000:201_200] = np.tile(np.array([1, 0, 3], np.uint8), 400)
    return "".join("ACTGN"[b] for b in arr)  # the 2-bit order


@pytest.mark.parametrize("k", [2, 8, 12])
def test_weight_pipeline_kernel_matches_plain(card, k, monkeypatch):
    """The device step of the exact path: K3 makes the scan histogram."""
    from kmer_spans_tpu_torch.spans.pipeline import (
        make_weight_span_pipeline,
        quantize_weight_table,
    )

    rng = np.random.default_rng(k)
    arr = _planted(k)
    w_q, _ = quantize_weight_table(rng.normal(-0.2, 1.0, 1 << (2 * k)), 0.0,
                                   4096)
    fn = make_weight_span_pipeline(k, cand_blocks=16, with_scan_counts=True,
                                   device=card)
    before = histogram.histogram_launches
    got = fn(arr, w_q)
    assert histogram.histogram_launches == before + 1
    # a graph captured with K3 replays K3: the plain histogram runs in
    # the eager chain (it syncs on the host, so no graph can hold it)
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    want = fn.eager(arr, w_q)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    idx = torch.tensor([0, 5, arr.size // 4096 - 1], device=card)
    for g, w in zip(fn.pull(arr, idx), make_weight_span_pipeline(
            k, device="cpu").pull(arr, idx.cpu())):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [1 << 12, 1 << 16, 1 << 20])
@pytest.mark.parametrize("k", [2, 8, 12])
def test_weight_step_graph_equals_eager(card, k, n):
    """Up to 2^20 positions the step replays a captured graph: bit for bit
    the eager chain, scan histogram included, for two tables in a row
    through the same graph; one K3 launch a replay, none at capture."""
    from kmer_spans_tpu_torch.spans import pipeline
    from kmer_spans_tpu_torch.spans.pipeline import (
        make_weight_span_pipeline,
        quantize_weight_table,
    )

    rng = np.random.default_rng(k * n)
    arr = rng.integers(0, 4, n).astype(np.uint8)
    arr[rng.random(n) < 0.002] = 4
    arr[1000:3000] = np.tile(np.array([0, 3], np.uint8), 1000)
    fn = make_weight_span_pipeline(k, cand_blocks=min(128, n // 4096),
                                   with_scan_counts=True, device=card)
    assert pipeline.uses_graph("cuda", n, k)
    captures = pipeline.graph_captures
    for i in range(2):
        w_q, _ = quantize_weight_table(
            rng.normal(-0.2 * (i + 1), 1.0, 1 << (2 * k)), 0.0, 4096)
        steps, launches = pipeline.graph_steps, histogram.histogram_launches
        got = {key: v.clone() for key, v in fn(arr, w_q).items()}
        assert pipeline.graph_steps == steps + 1
        assert histogram.histogram_launches == launches + 1
        want = fn.eager(arr, w_q)
        assert set(got) == set(want) and "scan_hist" in got
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
    assert pipeline.graph_captures - captures <= 1


def test_low_comp_regions_on_a_fragmented_assembly(card):
    """300 contigs across the graph's sizes and above them (2^12 to 2^21
    positions): the regions of the native library's caller, one replay a
    contig of at most 2^20 positions."""
    from kmer_spans_tpu_torch.parallel.device import bucket_size
    from kmer_spans_tpu_torch.spans import pipeline

    rng = np.random.default_rng(300)
    lengths = np.minimum(1000 + (rng.pareto(1.5, 300) * 8000).astype(int),
                         1_500_000)
    lengths[:3] = (1_200_000, 700_000, 3_000)
    seqs = []
    for n in lengths:
        arr = rng.integers(0, 4, n).astype(np.uint8)
        arr[rng.random(n) < 0.001] = 4
        for s in range(500, n - 900, 20_000):
            arr[s:s + 800] = np.tile(np.array([0, 3], np.uint8), 400)
        seqs.append("".join("ACTGN"[b] for b in arr))
    pads = [bucket_size(n) for n in lengths]
    assert min(pads) == 1 << 12 and max(pads) == 1 << 21
    steps = pipeline.graph_steps
    got = api.kmer_low_comp_regions(seqs, 8, 100, 20.0, thr=0.75,
                                    device=card)
    assert pipeline.graph_steps - steps == sum(p <= 1 << 20 for p in pads)
    want = api.kmer_low_comp_regions(seqs, 8, 100, 20.0, thr=0.75,
                                     backend="native")
    assert len(got.regions) >= 300
    assert np.array_equal(got.regions, want.regions)


def test_exact_k12_pulls_and_folds_from_the_table(card):
    """Three sequences (850,000 bases) at k = 12, the longest with a
    low-complexity island every 3,000 bases: more candidate blocks than
    its top C of 128, so the finish pulls the rest, and every stretch
    folds from the 4^12 rank table.  The regions equal the native
    library's caller's."""
    from kmer_spans_tpu_torch.spans import extract, finish

    rng = np.random.default_rng(24)
    seqs = []
    for n in (700_000, 60_000, 90_000):
        arr = rng.integers(0, 4, n).astype(np.uint8)
        arr[rng.random(n) < 0.0005] = 4
        for s in range(500, n - 700, 3_000):
            arr[s:s + 600] = np.tile(np.array([0, 3], np.uint8), 300)
        seqs.append("".join("ACTGN"[b] for b in arr))
    pulled = finish.pulled_blocks
    folds, tables = extract.native_folds, extract.table_folds
    got = api.kmer_low_comp_regions(seqs, 12, 100, 20.0, thr=0.75,
                                    device=card)
    assert finish.pulled_blocks > pulled
    assert extract.table_folds - tables == extract.native_folds - folds > 0
    want = api.kmer_low_comp_regions(seqs, 12, 100, 20.0, thr=0.75,
                                     backend="native")
    assert len(got.regions) >= 250
    assert np.array_equal(got.regions, want.regions)


@pytest.mark.parametrize("k", [8, 12])
def test_exact_api_on_card_equals_cpu(card, k):
    seq = _exact_genome(k)
    before = histogram.histogram_launches
    got = api.kmer_counts(seq, k, device=card)
    assert histogram.histogram_launches == before + 1
    want = api.kmer_counts(seq, k, device="cpu")
    assert got.n == want.n and np.array_equal(got.counts, want.counts)
    got = api.kmer_low_comp_regions(seq, k, 100, 20.0, device=card)
    want = api.kmer_low_comp_regions(seq, k, 100, 20.0, device="cpu")
    assert len(got.regions) >= 2
    for f in ("n", "counts", "regions", "w_rank"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("min_score", [20.0, -1.0])
def test_kmer_regions_on_card_equals_cpu(card, min_score):
    """min_score <= 0 pulls the candidate blocks the top C missed."""
    from kmer_spans_tpu_torch.encoding import all_kmers

    seq = _exact_genome(3, n=1_200_000)
    w = np.array([1.5 if "AGAG" in km or "CAGC" in km else -0.4
                  for km in all_kmers(8)])
    got = api.kmer_regions(seq, 8, w, 100, min_score, device=card)
    want = api.kmer_regions(seq, 8, w, 100, min_score, device="cpu")
    assert len(got.regions) >= 2
    for f in ("n", "counts", "regions"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("scoring", ["threshold", "log2_median"])
def test_kmer_spans_on_card_equals_cpu(card, scoring):
    seq = golden_genome()
    got = api.kmer_spans(seq, 8, scoring=scoring, device=card)
    want = api.kmer_spans(seq, 8, scoring=scoring, device="cpu")
    for f in ("n", "counts", "regions"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# ------------------------------------ windowed distributions, the tr caller

def _window_k3_input(card, seed, T=16, n=1 << 20, window=200, S=None):
    """K3's input at the window path's shape: the combined (kmer, count)
    indices of T tracked dimers over n window starts, neighbours within
    one count of each other, or (scaffold, kmer, count) with S scaffolds."""
    from kmer_spans_tpu_torch.ops.window import dist_values

    rng = np.random.default_rng(seed)
    steps = rng.integers(-1, 2, (T, n)).astype(np.int32)
    cnt = np.clip(np.cumsum(steps, axis=1) % (2 * window), 0, window)
    wv = rng.random(n) < 0.99
    wv[1000:3000] = False
    seg = None
    if S:
        seg = to_tensor(np.sort(rng.integers(0, S, n)).astype(np.int32),
                        card)
    values, valid, size = dist_values(
        to_tensor(cnt.astype(np.int32), card), to_tensor(wv, card), window,
        seg, S)
    return values, valid, size


@pytest.mark.parametrize("S", [None, 154])
def test_histogram_at_the_window_shapes(card, S):
    """3328 bins of near-equal neighbours (sliced form), and the cohort's
    S * 3232 bins (the merged cluster form for repeats)."""
    values, valid, size = _window_k3_input(card, 3 if S is None else S, S=S)
    assert size == (3328 if S is None else -(-154 * 3232 // 128) * 128)
    want = histogram_plain(values, valid, size)
    before = histogram.histogram_launches
    assert torch.equal(histogram.histogram(values, valid, size), want)
    assert histogram.histogram_launches == before + 1
    for form in histogram.FORMS:
        assert torch.equal(histogram.histogram_kernel(values, valid, size,
                                                      form), want)
    assert histogram.histogram_form(size, "repeats") == (
        "sliced" if S is None else "cluster_merged")


def _window_genome(seed, n):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 4, n).astype(np.uint8)
    arr[rng.random(n) < 0.0005] = 4
    arr[50_000:53_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    return arr


@pytest.mark.parametrize("with_positions", [False, True])
def test_windowed_counts_kernel_matches_plain_and_cpu(card, with_positions,
                                                      monkeypatch):
    from kmer_spans_tpu_torch.ops import window
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes

    arr = _window_genome(1, 40 * 8192)
    tracked = torch.arange(16, dtype=torch.int32)
    monkeypatch.setattr(window, "GROUP", 1 << 17)

    def run(dev):
        nb = to_tensor(arr, dev)
        b2, v2 = (nb & 3).reshape(-1, 8192), (nb < 4).reshape(-1, 8192)
        codes, kv = blocked_codes(b2, v2, 2)
        return window.windowed_counts_device(
            codes, kv, v2, tracked.to(dev), 2, 200,
            with_positions=with_positions, start_limit=39 * 8192)

    before = histogram.histogram_launches
    before_w = window.window_counts_launches
    got = run(card)
    torch.cuda.synchronize()
    assert histogram.histogram_launches == before + 3  # a launch a group
    assert window.window_counts_launches == before_w + 3
    want_cpu = run(torch.device("cpu"))
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    monkeypatch.setattr(window, "window_values", window.window_values_plain)
    want = run(card)
    for g, w, c in zip(got, want, want_cpu):
        if w is None:
            assert g is None and c is None
        else:
            assert torch.equal(g, w) and torch.equal(g.cpu(), c)


def test_window_api_on_card_equals_cpu(card):
    from kmer_spans_tpu_torch.ops import window
    from kmer_spans_tpu_torch.parallel import window_stream

    seqs = ["".join("ACTGN"[b] for b in _window_genome(s, n))
            for s, n in ((2, 300_000), (3, 70_000))]
    kmers = api.kmer_seq(2)
    before = histogram.histogram_launches
    before_w = window.window_counts_launches
    chunks = window_stream.chunks
    got = api.window_kmer_dist(seqs, kmers, 200, freq=False, ret_flag=1,
                               device=card)
    # a chunk is one group of starts: one launch of each kernel
    assert histogram.histogram_launches - before == \
        window_stream.chunks - chunks == 2
    assert window.window_counts_launches - before_w == 2
    want = api.window_kmer_dist(seqs, kmers, 200, freq=False, ret_flag=1,
                                device="cpu")
    assert np.array_equal(got.dist, want.dist)
    for g, w in zip(got.scores, want.scores):
        assert np.array_equal(g, w)
    got = api.window_kmer_dist(seqs, ["A"], 300, freq=False, ret_flag=1,
                               device=card)  # int16 positions
    want = api.window_kmer_dist(seqs, ["A"], 300, freq=False, ret_flag=1,
                                device="cpu")
    assert np.array_equal(got.dist, want.dist)
    for g, w in zip(got.scores, want.scores):
        assert np.array_equal(g, w)


def _window_flats(card, seed, n, k, block=8192, runs=()):
    """The flat codes, k-mer validity and base validity of a seeded
    sequence of n bases (a multiple of block) on the card, with sparse Ns,
    the N runs ``runs`` ((start, length)) and a 3000-base AT island."""
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes

    arr = _window_genome(seed, n)
    for a, b in runs:
        arr[a:a + b] = 4
    nb = to_tensor(arr, card)
    b2, v2 = (nb & 3).reshape(-1, block), (nb < 4).reshape(-1, block)
    codes, kv = blocked_codes(b2, v2, k)
    return codes.reshape(-1), kv.reshape(-1), v2.reshape(-1)


def _tracked_from(flat_c, flat_kv, T, seed):
    """T tracked codes drawn from the valid k-mers present (so that every
    row counts something), the last T // 4 of them repeats of others."""
    rng = np.random.default_rng(seed)
    present = flat_c[flat_kv].cpu().numpy()
    tr = rng.choice(present, T)
    dup = T // 4
    if dup:
        tr[T - dup:] = tr[rng.integers(0, T - dup, dup)]
    return to_tensor(tr.astype(np.int32), flat_c.device)


def _window_values_equal(flat_c, flat_kv, flat_v, tracked, k, window, lo,
                         hi, seg=None, n_seqs=None):
    """window_values against its plain version on the same CUDA tensors,
    with counts and without, one kernel launch each."""
    from kmer_spans_tpu_torch.ops import window as wmod

    args = (flat_c, flat_kv, flat_v, tracked, k, window, lo, hi, seg, n_seqs)
    for want_counts in (False, True):
        before = wmod.window_counts_launches
        got = wmod.window_values(*args, want_counts=want_counts)
        torch.cuda.synchronize()
        assert wmod.window_counts_launches == before + 1
        want = wmod.window_values_plain(*args, want_counts=want_counts)
        assert got[2] == want[2]
        for name, g, w in zip(("values", "valid", "wv", "cnt"),
                              got[:2] + got[3:], want[:2] + want[3:]):
            if w is None:
                assert g is None, name
            else:
                assert g.dtype == w.dtype and torch.equal(g, w), name


def test_window_values_full_group(card):
    """16 dimers at window 200 over one full group of 2^22 starts with its
    lookahead: the window cell's chunk shape."""
    from kmer_spans_tpu_torch.ops.window import GROUP

    c, kv, v = _window_flats(card, 11, GROUP + 8192, 2)
    tracked = torch.arange(16, dtype=torch.int32, device=card)
    _window_values_equal(c, kv, v, tracked, 2, 200, 0, GROUP)


@pytest.mark.parametrize("T", [1, 3, 17, 40])
def test_window_values_tracked_rows(card, T):
    """Any number of tracked rows, repeats of one code among them."""
    c, kv, v = _window_flats(card, 20 + T, 40 * 8192, 3)
    tracked = _tracked_from(c, kv, T, T)
    _window_values_equal(c, kv, v, tracked, 3, 50, 0, 39 * 8192 + 5)


@pytest.mark.parametrize("k", [1, 5, 12, 15])
def test_window_values_k(card, k):
    c, kv, v = _window_flats(card, 30 + k, 32 * 8192, k,
                             runs=((100_000, 5000),))
    tracked = _tracked_from(c, kv, 8, k)
    for window in (2 * k, 2 * k + 37, 200):
        _window_values_equal(c, kv, v, tracked, k, window, 0, 31 * 8192)


@pytest.mark.parametrize("window", [4, 57, 200, 201, 1023, 1025, 4096, 4097,
                                    16384, 16385, 70_000])
def test_window_values_windows(card, window):
    """Windows from 2k up, across the run sizes the kernel picks (1024
    starts a sub-tile, up to 16 of them, the first window read from
    shared memory up to a run's length and from L2 beyond)."""
    c, kv, v = _window_flats(card, 40, 48 * 8192, 2, runs=((9000, 300),))
    tracked = _tracked_from(c, kv, 5, 5)
    _window_values_equal(c, kv, v, tracked, 2, window, 0, 40 * 8192)


def test_window_values_edges(card):
    """N runs, the padded tail past n, starts from an unaligned lo and a
    start_limit in the middle of a sub-tile (m not a multiple of 4)."""
    n = 24 * 8192
    c, kv, v = _window_flats(card, 50, n, 2,
                             runs=((0, 17), (4000, 1), (70_000, 20_000)))
    tracked = torch.arange(16, dtype=torch.int32, device=card)
    for lo, hi in ((0, n), (3, n - 1), (0, 12_345), (1, 2), (777, 777 + 4099),
                   (n - 150, n)):
        _window_values_equal(c, kv, v, tracked, 2, 200, lo, hi)


@pytest.mark.parametrize("with_positions", [False, True])
def test_windowed_counts_edges_on_card(card, with_positions, monkeypatch):
    """windowed_counts_device with a start_limit mid-tile, several groups
    and a window of 70,000 (without positions: the int16 matrix stops at
    32,765), against its plain chain on the card."""
    from kmer_spans_tpu_torch.ops import window

    monkeypatch.setattr(window, "GROUP", 1 << 16)
    n = 40 * 8192
    c, kv, v = _window_flats(card, 60, n, 2, runs=((200_000, 40),))
    c2, kv2, v2 = (x.reshape(-1, 8192) for x in (c, kv, v))
    tracked = torch.arange(16, dtype=torch.int32, device=card)
    for w, limit in ((200, n - 8192 - 3), (70_000, None)):
        if with_positions and w > 32_765:
            continue
        starts = n if limit is None else limit
        before = window.window_counts_launches
        got = window.windowed_counts_device(
            c2, kv2, v2, tracked, 2, w, with_positions=with_positions,
            start_limit=limit)
        torch.cuda.synchronize()
        groups = -(-starts // (1 << 16))
        assert window.window_counts_launches == before + groups
        with monkeypatch.context() as mp:
            mp.setattr(window, "window_values", window.window_values_plain)
            want = window.windowed_counts_device(
                c2, kv2, v2, tracked, 2, w, with_positions=with_positions,
                start_limit=limit)
        for g, x in zip(got, want):
            assert (g is None and x is None) or torch.equal(g, x)


def test_window_values_cohort(card, monkeypatch):
    """The cohort mode: 154 scaffolds, single-N separators, each start's
    scaffold in seg, (scaffold, kmer, count) indices; one group and the
    whole windowed_counts_device(seg2d=...) call."""
    from kmer_spans_tpu_torch.ops import window
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes

    rng = np.random.default_rng(154)
    lengths = np.minimum(400_000, 20_000 + rng.pareto(1.2, 154) * 20_000)
    lengths = lengths.astype(np.int64)
    npad = -(-(int(lengths.sum()) + 154) // 8192) * 8192
    cat = np.full(npad, 4, np.uint8)
    seg = np.full(npad, 153, np.int32)
    pos = 0
    for i, L in enumerate(lengths):
        cat[pos:pos + L] = rng.integers(0, 4, L)
        seg[pos:pos + L + 1] = i
        pos += int(L) + 1
    nb = to_tensor(cat, card)
    b2, v2 = (nb & 3).reshape(-1, 8192), (nb < 4).reshape(-1, 8192)
    codes, kv = blocked_codes(b2, v2, 2)
    seg2 = to_tensor(seg, card).reshape(-1, 8192)
    tracked = torch.arange(16, dtype=torch.int32, device=card)
    _window_values_equal(codes.reshape(-1), kv.reshape(-1), v2.reshape(-1),
                         tracked, 2, 200, 0, window.GROUP, seg2.reshape(-1),
                         154)
    before = window.window_counts_launches
    got = window.windowed_counts_device(codes, kv, v2, tracked, 2, 200,
                                        seg2d=seg2, n_seqs=154)
    torch.cuda.synchronize()
    assert window.window_counts_launches == before + -(-npad // window.GROUP)
    monkeypatch.setattr(window, "window_values", window.window_values_plain)
    want = window.windowed_counts_device(codes, kv, v2, tracked, 2, 200,
                                         seg2d=seg2, n_seqs=154)
    for g, x in zip(got, want):
        assert (g is None and x is None) or torch.equal(g, x)


@pytest.mark.parametrize("k", [2, 8])
def test_tr_pipeline_on_card_equals_cpu(card, k):
    """No kernel on this path: the card's cumsum / cummax forms against
    the CPU's, summaries, runstats, pulled rows and regions."""
    from kmer_spans_tpu_torch.encoding import all_kmers
    from kmer_spans_tpu_torch.spans import tr_pipeline as tr

    arr = _window_genome(k, 64 * 8192)
    kms = all_kmers(k)
    hot = ("AG", "GA") if k == 2 else ("AGAGAGAG", "GAGAGAGA")
    ks = np.array([2.0 if km in hot else -1.0 for km in kms])
    ts = np.array([2.0 if km in hot else -0.5 for km in kms])
    ks_q, ts_q, _ = tr.quantize_tr_tables(ks, ts, 8192)
    halo = np.array([0, 3] * k, np.uint8)[:k]
    x32 = np.random.default_rng(k).choice([0, 7, 1 << 20], 64).astype(
        np.int32)
    idx = np.array([0, 6, 63, 6], np.int64)
    outs = []
    for dev in (card, torch.device("cpu")):
        pipe = tr.make_tr_pipeline(k, device=dev)
        nb = to_tensor(arr, dev)
        s = pipe.summaries(nb, ks_q, ts_q, halo)
        r = pipe.runstats(nb, ks_q, ts_q, x32, halo)
        p = pipe.pull(nb, idx, halo)
        outs.append([v.cpu() for v in (*s.values(), *r, *p)])
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    seq = "".join("ACTGN"[b] for b in arr)
    got = api.lr_regions(seq, (k, 100), kms, ks, ts, device=card)
    want = api.lr_regions(seq, (k, 100), kms, ks, ts, device="cpu")
    assert len(got.regions) >= 1
    assert np.array_equal(got.regions, want.regions)


def _stream_genome(seed, n):
    """Random bases (N as 4) with AG islands and N gaps across the 2^19
    chunk edges."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[rng.random(n) < 0.001] = 4
    for s in range((1 << 19) - 1500, n - 4000, 1 << 19):
        g[s:s + 3000] = np.tile(np.array([0, 3], np.uint8), 1500)
        g[s + 200_000:s + 200_100] = 4
    return g


@pytest.mark.parametrize("k,block,screen", [
    (8, 8192, "fused_screen_scan"), (4, 512, "word_gather"),
    (9, 8192, "word_gather"), (12, 8192, None)])
def test_stream_kernels_match_plain(card, k, block, screen, monkeypatch):
    """The stream on the card (K3 count; K2, K4 or the row gather) against
    the same run with the plain versions and against the CPU: spectra,
    per-chunk summaries, regions."""
    from kmer_spans_tpu_torch.parallel.stream import StreamingSpanPipeline

    g = _stream_genome(k, 1 << 21)
    nchunks = 4

    def chunks():
        for i in range(0, g.size, 1 << 19):
            yield g[i:i + (1 << 19)]

    def run(dev):
        # the margins cover the excursion after a 3000-base island
        pipe = StreamingSpanPipeline(k, chunk_bases=1 << 19, block=block,
                                     cand_blocks=8,
                                     margin_blocks=(1 << 14) // block,
                                     device=dev)
        rec = []
        orig = pipe._finish_chunk

        def keep(*a, **kw):
            rec.append([np.array(v) for v in a[:5]])
            return orig(*a, **kw)

        pipe._finish_chunk = keep
        res = pipe.run(chunks, 0.75, 100, 20.0)
        return res, rec

    before = (histogram.histogram_launches, screen_scan.launches,
              gather.launches)
    got, rec = run(card)
    launched = (histogram.histogram_launches - before[0],
                screen_scan.launches - before[1], gather.launches - before[2])
    assert launched == (nchunks,
                        nchunks if screen == "fused_screen_scan" else 0,
                        nchunks if screen == "word_gather" else 0)
    assert got.unresolved == [] and len(got.regions) >= 3
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    monkeypatch.setattr(screen_scan, "fused_screen_scan",
                        fused_screen_scan_plain)
    monkeypatch.setattr(gather, "word_gather", word_gather_plain)
    for want, want_rec in (run(card), run("cpu")):
        assert np.array_equal(got.counts_host, want.counts_host)
        assert got.regions == want.regions
        assert got.unresolved == want.unresolved
        for r, w in zip(rec, want_rec, strict=True):
            assert all(np.array_equal(a, b) for a, b in zip(r, w))


def test_stream_needs_a_card_for_cuda(card, monkeypatch):
    from kmer_spans_tpu_torch.parallel.stream import StreamingSpanPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSpanPipeline(8, chunk_bases=1 << 16, device="cuda")


# ------------------------------------------------------- wide codes

def _wide_genome(seed, n=1 << 21):
    """Random bases (N as 4) with AG islands and N gaps, 2^21 bases."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[rng.random(n) < 0.001] = 4
    for s in range(100_000, n - 4000, 500_000):
        g[s:s + 3000] = np.tile(np.array([0, 3], np.uint8), 1500)
    return g


@pytest.mark.parametrize("k", [16, 17, 23])
def test_wide_pm_pipeline_kernel_matches_plain(card, k, monkeypatch):
    """The wide pm pipeline: K3 once, equal to the plain value histogram
    on the card and to the CPU; every island called."""
    from kmer_spans_tpu_torch.spans import pm_finish
    from kmer_spans_tpu_torch.spans.pm_pipeline import make_wide_pm_pipeline

    g = _wide_genome(k)
    fn, meta = make_wide_pm_pipeline(k, cand_blocks=16, device=card)
    before = histogram.histogram_launches
    got = fn(g, 0.75)
    assert histogram.histogram_launches == before + 1
    cpu = make_wide_pm_pipeline(k, cand_blocks=16, device="cpu")[0](g, 0.75)
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    assert torch.equal(got, fn(g, 0.75))
    assert torch.equal(got.cpu(), cpu)
    out = pm_finish.unpack_pm_outputs(got.cpu().numpy(), g.size, meta)
    res = pm_finish.finish_pm_spans(out, g.size, meta, 0.75, 100, 20.0)
    assert not res.fallback and len(res.regions) >= 4


def test_wide_sort_pipeline_kernels_match_plain(card, monkeypatch):
    """The wide sort screen: K3 twice and K4 once, equal to the plain
    versions on the card and to the CPU; its regions equal the pm
    route's."""
    from kmer_spans_tpu_torch.parallel.device import device_sparse_spectrum
    from kmer_spans_tpu_torch.spans import finish, pm_finish
    from kmer_spans_tpu_torch.spans.pipeline import make_wide_span_pipeline
    from kmer_spans_tpu_torch.spans.pm_pipeline import make_wide_pm_pipeline

    k, g = 17, _wide_genome(5)
    fn = make_wide_span_pipeline(k, cand_blocks=16, device=card)
    before = histogram.histogram_launches, gather.launches
    got = fn(g, 0.75)
    assert (histogram.histogram_launches - before[0],
            gather.launches - before[1]) == (2, 1)
    cpu = make_wide_span_pipeline(k, cand_blocks=16, device="cpu")(g, 0.75)
    spectrum = device_sparse_spectrum(g, k, device=card)
    want_spectrum = device_sparse_spectrum(g, k, device="cpu")
    for a, b in zip(spectrum, want_spectrum):
        assert np.array_equal(a, b)
    monkeypatch.setattr(histogram, "histogram", histogram_plain)
    monkeypatch.setattr(gather, "word_gather", word_gather_plain)
    assert torch.equal(got, fn(g, 0.75))
    assert torch.equal(got.cpu(), cpu)
    out = finish.unpack_wide_outputs(got.cpu().numpy(), g.size, 8192, 16)
    res = finish.finish_wide_spans(out, g.size, k, 0.75, 100, 20.0, spectrum)
    pfn, meta = make_wide_pm_pipeline(k, cand_blocks=16, device=card)
    pm_out = pm_finish.unpack_pm_outputs(pfn(g, 0.75).cpu().numpy(), g.size,
                                         meta)
    pm_res = pm_finish.finish_pm_spans(pm_out, g.size, meta, 0.75, 100, 20.0)
    assert not res.fallback and res.regions == pm_res.regions
    assert len(res.regions) >= 4


def test_wide_api_on_card_equals_cpu(card, monkeypatch):
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    seq = golden_genome()
    got = api.kmer_wide_regions(seq, 17, 100, 20.0, device=card)
    want = api.kmer_wide_regions(seq, 17, 100, 20.0, device="cpu")
    assert len(got.regions) == 3 and api.exact_fallbacks == 0
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.spectrum_codes, want.spectrum_codes)
    assert np.array_equal(got.spectrum_counts, want.spectrum_counts)
    assert got.n_words == want.n_words == 99_984


# ------------------------------------------------- the multi-device paths

@pytest.fixture(scope="module")
def world_one():
    """This process alone as a process group: NCCL on the card, and a gloo
    sub-group of it on the CPU.  Yields (card group, CPU group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    import tempfile

    import torch.distributed as dist

    from kmer_spans_tpu_torch.parallel.collectives import DataGroup
    from kmer_spans_tpu_torch.parallel.multihost import initialize

    with tempfile.TemporaryDirectory() as tmp:
        initialize(f"file://{tmp}/store", 1, 0, device="cuda")
        try:
            yield (DataGroup.of("cuda"),
                   DataGroup.of("cpu", dist.new_group([0], backend="gloo")))
        finally:
            dist.destroy_process_group()


def _mesh_runs(grp_card, grp_cpu, fn, monkeypatch):
    """fn(grp) with the kernels on the card (launches counted), with the
    plain versions on the card and on the CPU: (outputs of each as CPU
    tensors, (K3, K4) launches of the kernels' run)."""
    before = histogram.histogram_launches, gather.launches
    got = fn(grp_card)
    torch.cuda.synchronize()
    launched = (histogram.histogram_launches - before[0],
                gather.launches - before[1])
    with monkeypatch.context() as m:
        m.setattr(histogram, "histogram", histogram_plain)
        m.setattr(gather, "word_gather", word_gather_plain)
        plain = fn(grp_card)
    cpu = fn(grp_cpu)
    return [[t.cpu() for t in out] for out in (got, plain, cpu)], launched


def test_mesh_step_kernels_match_plain_and_cpu(world_one, monkeypatch):
    """The k = 8 mesh step on 2^21 bases: K3 once; counts, scored and S
    equal to the plain versions on the card; counts and scored equal to
    gloo on the CPU, S within 1e-6 of it (f64 sums in another order)."""
    from kmer_spans_tpu_torch.parallel.pipeline import make_pipeline_step

    g = _wide_genome(8)

    def run(grp):
        x = to_tensor(g, grp.device)
        return make_pipeline_step(grp, 8, block=8192)(x & 3, x < 4, 0.75)

    (got, plain, cpu), launched = _mesh_runs(*world_one, run, monkeypatch)
    assert launched == (1, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert torch.equal(got[0], cpu[0]) and torch.equal(got[2], cpu[2])
    np.testing.assert_allclose(got[1].numpy(), cpu[1].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float(got[1].max()) > 100.0  # the islands' excursions


@pytest.mark.parametrize("k,launches", [(13, (1, 0)), (17, (2, 1))])
def test_sharded_scans_kernels_match_plain_and_cpu(world_one, k, launches,
                                                   monkeypatch):
    """The k = 13 sharded scan (count K3; wide rank step; scan) and the
    wide k = 17 scan (K3 twice, K4) on 2^21 bases: every output equal to
    the plain versions on the card and to gloo on the CPU; the regions
    equal the single-device pm route's."""
    from kmer_spans_tpu_torch.parallel.sharded import make_sharded_count_step
    from kmer_spans_tpu_torch.parallel.sharded_scan import (
        finish_sharded_spans,
        make_sharded_rank_step_wide,
        make_sharded_scan_step,
    )
    from kmer_spans_tpu_torch.parallel.wide_scan import (
        finish_wide_sharded,
        make_wide_sharded_scan,
    )
    from kmer_spans_tpu_torch.spans import pm_finish
    from kmer_spans_tpu_torch.spans.pm_pipeline import (
        make_pm_span_pipeline,
        make_wide_pm_pipeline,
    )

    g = _wide_genome(k)

    def run(grp):
        x = to_tensor(g, grp.device)
        bases, valid = x & 3, x < 4
        if k == 17:
            return make_wide_sharded_scan(grp, k, block=8192, cand_blocks=16)(
                bases, valid, 0.75)
        counts, c_over = make_sharded_count_step(grp, k, block=8192)(bases,
                                                                     valid)
        mass, clip, vhist = make_sharded_rank_step_wide(grp, k)(counts)
        return make_sharded_scan_step(grp, k, block=8192, cand_blocks=16)(
            bases, valid, mass, int(vhist.sum()), 0.75) + (c_over, clip,
                                                           vhist)

    (got, plain, cpu), launched = _mesh_runs(*world_one, run, monkeypatch)
    assert launched == launches
    for want in (plain, cpu):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    out = tuple(t.numpy() for t in got)
    n = g.size
    if k == 17:
        res = finish_wide_sharded(out, n, k, 0.75, 100, 20.0,
                                  (out[9], out[10], int(out[7])), 8192)
        fn, meta = make_wide_pm_pipeline(k, cand_blocks=16, device="cpu")
    else:
        res = finish_sharded_spans(out[:8], n, int(out[10].sum()), 0.75, 100,
                                   20.0, 8192, value_hist=out[10])
        fn, meta = make_pm_span_pipeline(k, cand_blocks=16, device="cpu")
    pm = pm_finish.finish_pm_spans(
        pm_finish.unpack_pm_outputs(fn(g, 0.75).numpy(), n, meta), n, meta,
        0.75, 100, 20.0)
    assert not res.fallback and not res.overflow and len(res.regions) >= 4
    assert res.regions == pm.regions


def test_step_spans_read_the_device_time_of_their_events(card):
    """On the card each ``regions.step`` span carries the device time of
    its CUDA event pair, read once the outputs' copy has waited for it;
    the regions equal the CPU path's with the recorder on."""
    g = golden_genome()
    want = api.kmer_low_comp_regions(g, 8, 100, 20.0, thr=0.75,
                                     device="cpu").regions
    with metrics.tracing() as rec:
        got = api.kmer_low_comp_regions(g, 8, 100, 20.0, thr=0.75,
                                        device=card).regions
    steps = [s for s in rec.spans if s.name == "regions.step"]
    assert steps and all(s.attrs["device_ms"] > 0 for s in steps)
    assert got.tobytes() == want.tobytes()
