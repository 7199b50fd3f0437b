"""The port's stream across passes and runs: several streams into one
spectrum, kill-and-resume from a chunk checkpoint (the port's own and the
JAX package's), the capacity pull that replaces the reference's
"candidate capacity overflow", and the exact api path on the same
sequence.  Also the checkpoint and metrics copies against the JAX
package's.
"""

import logging

import numpy as np
import pytest

from kmer_spans_tpu.io import checkpoint as ref_checkpoint
from kmer_spans_tpu.parallel.stream import StreamingSpanPipeline as JaxStream
from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.encoding import kmer_to_code
from kmer_spans_tpu_torch.io import checkpoint
from kmer_spans_tpu_torch.models.scoring import WeightScoring
from kmer_spans_tpu_torch.oracle import count_spectrum, find_regions
from kmer_spans_tpu_torch.parallel import stream
from kmer_spans_tpu_torch.parallel.stream import (
    StreamingSpanPipeline,
    tail_close,
)
from kmer_spans_tpu_torch.utils.metrics import Metrics

from test_torch_stream import chunks_of, nbases_of, oracle_regions, planted


def _pipe(k=4, chunk=8192, block=512, cand=32, margin=4):
    return StreamingSpanPipeline(k, chunk_bases=chunk, block=block,
                                 cand_blocks=cand, margin_blocks=margin,
                                 device="cpu")


def _resume_seq():
    """tests/test_aux.py's resume genome: islands across the first edge
    and in chunk 2."""
    s = list(planted(4, 30_000, islands=(), n_prob=0.0))
    s[7900:8600] = "AG" * 350
    s[20000:20700] = "CT" * 350
    return "".join(s)


def test_accumulate_two_scaffolds_equals_one_joined_spectrum():
    s1 = planted(11, 20_000)
    s2 = planted(12, 13_000, islands=(5000,))
    pipe = _pipe(k=6)
    acc = pipe.accumulate_counts(chunks_of(nbases_of(s1), 8192))
    acc = pipe.accumulate_counts(chunks_of(nbases_of(s2), 8192), acc=acc)
    _, total = pipe.finish_rank(acc)
    joined, n = count_spectrum(s1 + "N" + s2, 6)
    assert total == n
    assert np.array_equal(pipe._counts_host, joined)
    ref = JaxStream(6, chunk_bases=8192, block=512, cand_blocks=32,
                    margin_blocks=4)
    racc = ref.accumulate_counts(chunks_of(nbases_of(s1), 8192))
    racc = ref.accumulate_counts(chunks_of(nbases_of(s2), 8192), acc=racc)
    ref.finish_rank(racc)
    assert np.array_equal(pipe._counts_host, ref._counts_host)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_equals_the_uninterrupted_run(tmp_path, writer):
    """Kill after chunk 1, resume from the checkpoint (written by the port
    or by the JAX package): equal to the uninterrupted run."""
    nb = nbases_of(_resume_seq())
    full = _pipe().run(chunks_of(nb, 8192), 0.75, 30, 5.0)
    assert full.regions and full.unresolved == []
    ckpt = str(tmp_path / "stream.npz")
    first = _pipe() if writer == "port" else JaxStream(
        4, chunk_bases=8192, block=512, cand_blocks=32, margin_blocks=4)
    part = first.run(chunks_of(nb, 8192), 0.75, 30, 5.0,
                     checkpoint_path=ckpt, stop_after_chunk=1)
    assert checkpoint.StreamCheckpoint.load(ckpt).chunk_idx == 1
    assert len(part.regions) < len(full.regions)
    resumed = _pipe().run(chunks_of(nb, 8192), 0.75, 30, 5.0,
                          checkpoint_path=ckpt, resume=True)
    assert resumed.regions == full.regions
    assert resumed.unresolved == full.unresolved


def test_capacity_overflow_is_pulled_from_the_device():
    """More candidate blocks than C in one chunk: JAX reports "candidate
    capacity overflow"; the port pulls the missed blocks in batches of C
    and equals the oracle."""
    seq = planted(21, 32_768, islands=tuple(range(1000, 31000, 2500)))
    nb = nbases_of(seq)
    ref = JaxStream(4, chunk_bases=16384, block=512, cand_blocks=2,
                    margin_blocks=4)
    want = ref.run(chunks_of(nb, 16384), 0.75, 30, 5.0)
    assert any(r == "candidate capacity overflow" for _, r in want.unresolved)
    pipe = _pipe(chunk=16384, cand=2)
    got = pipe.run(chunks_of(nb, 16384), 0.75, 30, 5.0)
    assert pipe.pull_batches > 0
    assert got.unresolved == []
    expect = oracle_regions(seq, 4, 0.75, 30, 5.0)
    assert len(expect) >= 12
    assert sorted(got.regions) == sorted(expect)


@pytest.mark.parametrize("k", [8, 11])
def test_stream_equals_the_exact_api_path(k):
    seq = planted(30 + k, 40_000, gaps=(8100, 24500))
    nb = nbases_of(seq)
    got = _pipe(k=k, chunk=16384, block=1024).run(
        chunks_of(nb, 16384), 0.75, 30, 5.0)
    want = api.kmer_low_comp_regions(seq, k, 30, 5.0, thr=0.75,
                                     device="cpu")
    assert got.unresolved == []
    assert len(got.regions) >= 3
    assert got.regions == [(int(r["seq_id"]), int(r["beg"]), int(r["end"]),
                            float(r["score"])) for r in want.regions]
    assert got.n_kmers == want.n[0]


def test_stream_checkpoint_loads_in_both_packages(tmp_path):
    ck = checkpoint.StreamCheckpoint(
        chunk_idx=3, x_in=(1 << 40) + 12, halo_bytes=b"\x01\x02\x04",
        open_start=12345, open_s=np.array([0.1, -0.2]),
        open_scored=np.array([True, False]),
        regions=[(0, 10, 20, 5.5), (0, 30, 99, 0.1 + 0.2)],
    )
    p = str(tmp_path / "port.npz")
    ck.save(p)
    back = ref_checkpoint.StreamCheckpoint.load(p)
    for f in ("chunk_idx", "x_in", "halo_bytes", "open_start", "regions"):
        assert getattr(back, f) == getattr(ck, f), f
    np.testing.assert_array_equal(back.open_s, ck.open_s)
    np.testing.assert_array_equal(back.open_scored, ck.open_scored)
    q = str(tmp_path / "jax.npz")
    ref_checkpoint.StreamCheckpoint(
        chunk_idx=0, x_in=0, halo_bytes=b"", open_start=0, open_s=None,
        open_scored=None, regions=[]).save(q)
    empty = checkpoint.StreamCheckpoint.load(q)
    assert empty.open_s is None and empty.regions == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spectrum_shards_load_in_both_packages(tmp_path, writer):
    counts = np.arange(4 ** 6, dtype=np.int64) * 3
    save = (checkpoint if writer == "port" else ref_checkpoint)
    save.save_spectrum_sharded(str(tmp_path / "ck"), counts, 6, n_shards=7)
    for mod in (checkpoint, ref_checkpoint):
        back, k = mod.load_spectrum_sharded(str(tmp_path / "ck"))
        assert k == 6 and np.array_equal(back, counts)


def test_metrics_phases(caplog):
    m = Metrics()
    with caplog.at_level(logging.INFO, logger="kmer_spans_tpu_torch"):
        with m.phase("count", bases=1000):
            pass
    m.record("scan_chunk", 0.5, bases=100, chunk=0)
    s = m.summary()
    assert [p["name"] for p in s["phases"]] == ["count", "scan_chunk"]
    assert s["phases"][1] == {"name": "scan_chunk", "seconds": 0.5,
                              "bases": 100, "bases_per_sec": 200.0,
                              "chunk": 0}
    assert "phase=count" in caplog.text


def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSpanPipeline(8, chunk_bases=1 << 16)


def test_margin_beyond_the_chunk(golden):
    """A margin of more blocks than the chunk holds (the CLI's default 16
    blocks of 8192 at a 65536-base chunk): the reference raises, the port
    takes the whole chunk as its margin and equals the oracle."""
    nb = nbases_of(golden)
    with pytest.raises(ValueError):
        JaxStream(12, chunk_bases=65536).run(chunks_of(nb, 65536), 0.75,
                                             100, 20.0)
    pipe = StreamingSpanPipeline(12, chunk_bases=65536, device="cpu")
    got = pipe.run(chunks_of(nb, 65536), 0.75, 100, 20.0)
    assert pipe.margin == 8 and got.unresolved == []
    assert got.regions == oracle_regions(golden, 12, 0.75, 100, 20.0)


def _sequential_fold(s, sc, x0):
    """The reference's S_i = max(S_{i-1} + s_i, 0) from S_{-1} = x0, one
    position at a time, reset to 0 where unscored."""
    out, S = [], x0
    for v, scored in zip(s.tolist(), sc.tolist()):
        S = max(S + v, 0.0) if scored else 0.0
        out.append(S)
    return np.array(out)


def _vector_closes(s, sc, x0):
    P = np.cumsum(s)
    Mn = np.minimum.accumulate(np.minimum(P, 0.0))
    return np.nonzero((np.maximum(P + x0, P - Mn) <= 0) | ~sc)[0]


def test_tail_close_confirmed_by_the_sequential_fold():
    """k = 1 under weights A -0.3, C 0.1, G 0.2, T -1.0: chunk 0's tail
    margin opens T C G A and then G to the chunk edge and on.  The
    vectorized bound closes at the A (-1 + 0.1 + 0.2 - 0.3 rounds below
    -1), the sequential fold does not (0.1 + 0.2 - 0.3 = 5.55e-17 > 0):
    the true excursion starts at the C.  The stream's regions equal the
    oracle's, beg/end exact and f64 scores ==, and the close search picks
    the T, where the sequential S is 0."""
    chunk, block, margin = 8192, 512, 4
    seq = list("T" * 2 * chunk)
    tail = chunk - margin * block
    seq[tail + 1:tail + 4] = "CGA"
    seq[tail + 4:chunk + 300] = "G" * (chunk + 300 - tail - 4)
    seq = "".join(seq)
    weights = np.zeros(4)
    for base, w in zip("ACGT", (-0.3, 0.1, 0.2, -1.0)):
        weights[kmer_to_code(base)] = w
    pipe = _pipe(k=1, chunk=chunk, block=block, margin=margin)
    got = pipe.run(chunks_of(nbases_of(seq), chunk), 0.0, 30, 5.0,
                   scoring=lambda counts, total: WeightScoring(weights))
    want = find_regions(seq, 0, 30, 5.0, weights, 1, 0.0)
    assert got.unresolved == []
    assert len(want) == 1 and want[0][1] == tail + 2  # the C, 1-based
    assert got.regions == [(i, b, e, float(s)) for i, b, e, s in want]

    # the close search on the same tail: x0_ub = 0 (T before the margin)
    s = weights[[kmer_to_code(b) for b in seq[tail:chunk]]]
    sc = np.ones(s.shape[0], bool)
    seq_S = _sequential_fold(s, sc, 0.0)
    assert _vector_closes(s, sc, 0.0)[-1] == 3 and seq_S[3] > 0
    close = tail_close(s, sc, 0.0, np.zeros(s.shape[0], bool))
    assert close == 0 and seq_S[close] == 0.0
    assert (seq_S[close + 1:] > 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tail_close_equals_the_sequential_fold(seed):
    """Random tails of 0.1-step scores, unscored resets, zeros of the
    integer bound and an entry bound of 0 or above: the close search
    returns the last position at or before the vectorized bound's last
    close where the sequential fold (from the entry bound, reset at the
    anchors) is 0, and some of them move off the bound's choice."""
    rng = np.random.default_rng(seed)
    moved = 0
    for _ in range(400):
        n = int(rng.integers(1, 300))
        s = rng.choice([0.1, 0.2, -0.3, 0.3, -0.1, -0.2, 0.7, -1.0], n)
        sc = rng.random(n) > 0.01
        s[~sc] = 0.0
        x0 = float(rng.choice([0.0, 0.3, 2.0]))
        bz = np.zeros(n, bool)
        if rng.random() < 0.3:
            bz[rng.integers(0, n, 2)] = True
        closes = _vector_closes(s, sc, x0)
        c = int(closes[-1]) if closes.size else n - 1
        S = _sequential_fold(s, sc & ~bz, x0)[:c + 1]
        zeros = np.nonzero(S == 0.0)[0]
        want = int(zeros[-1]) if zeros.size else (-1 if x0 == 0 else None)
        got = tail_close(s, sc, x0, bz)
        assert got == want
        moved += closes.size > 0 and got != c
    assert moved > 0


def _sums(w):
    """Strictly sequential f64 partial sums of ``w``, from 0."""
    acc, total = [], 0.0
    for v in w:
        total += v
        acc.append(total)
    return np.array(acc)


@pytest.mark.parametrize("block_elems", [1 << 20, 64])
def test_segment_sums_equal_sequential_sums(monkeypatch, block_elems):
    """Each stretch summed from 0, left to right: the first sum <= 0, in
    one block or in blocks of one power-of-two width (at most 64
    elements a block)."""
    monkeypatch.setattr(stream, "_BLOCK_ELEMS", block_elems)
    rng = np.random.default_rng(3)
    w = rng.choice(np.round(np.arange(-6, 6) / 10.0 + 0.05, 2), 5000)
    w[rng.integers(0, 5000, 5)] = -np.inf
    cuts = np.sort(rng.choice(np.arange(1, 5000), 700, replace=False))
    starts = np.concatenate(([0], cuts))
    lens = np.diff(np.concatenate((starts, [5000])))
    first = stream._segment_sums(w, starts, lens)
    for i, (a, ln) in enumerate(zip(starts, lens)):
        nonpos = np.flatnonzero(_sums(w[a:a + ln]) <= 0)
        assert first[i] == (int(nonpos[0]) if nonpos.size else int(ln))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_nonpositive_equals_sequential_sums(seed):
    """The walk from u, in chunks doubled from 64: the fold's sums from 0
    up to its first sum <= 0, which is z (None where there is none)."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 6000))
        s = rng.choice([0.1, 0.2, -0.3, 0.3, -0.1, 0.05], n)
        u = int(rng.integers(0, n))
        got, z = stream._first_nonpositive(s, u)
        want = _sums(s[u:])
        nonpos = np.flatnonzero(want <= 0)
        if nonpos.size:
            assert z == u + int(nonpos[0])
            want = want[:nonpos[0] + 1]
        else:
            assert z is None
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_check_equals_sequential_sums(seed):
    """The first segment (restarted at 0 after each end) whose sums do
    not stay above 0 before its end and reach <= 0 at it, with where
    they first reach <= 0."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n = int(rng.integers(2, 400))
        w = rng.choice([0.1, 0.2, -0.3, 0.3, -0.1, -0.2, 0.7], n)
        lo = int(rng.integers(0, n // 2))
        ends = np.unique(rng.integers(lo, n, int(rng.integers(1, 8))))
        want_i, want_j = ends.size, None
        a = lo
        for i, e in enumerate(ends.tolist()):
            nonpos = np.flatnonzero(_sums(w[a:e + 1]) <= 0)
            if not (nonpos.size and nonpos[0] == e - a):
                want_i = i
                want_j = a + int(nonpos[0]) if nonpos.size else None
                break
            a = e + 1
        assert stream._segment_check(w, lo, ends) == (want_i, want_j)
