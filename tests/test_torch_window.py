"""The port's windowed distributions against the JAX package's.

ops/window.py windowed_counts_device and parallel/window_stream.py
StreamingWindowEngine, on the CPU (K3's plain version), against the JAX
package's on the same seeded inputs (its K3 in interpret mode, as
tests/test_window_device.py runs it) and the sequential oracle.  Every
output is an integer: dist, the int16 / uint8-packed positions and the
window validity must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_spans_tpu.ops import blocked as ref_blocked
from kmer_spans_tpu.ops.window import windowed_counts_device as ref_wcd
from kmer_spans_tpu.oracle import windowed_distributions as ref_oracle_wd
from kmer_spans_tpu.parallel import window_stream as ref_stream
from kmer_spans_tpu_torch.encoding import kmer_to_code, pack
from kmer_spans_tpu_torch.ops import blocked, histogram, window
from kmer_spans_tpu_torch.oracle import windowed_distributions
from kmer_spans_tpu_torch.parallel import window_stream

from conftest import random_seq


def _blocked(seq, block):
    p = pack(seq)
    npad = -(-p.n // block) * block
    b = np.zeros(npad, np.uint8)
    b[: p.n] = p.bases
    v = np.zeros(npad, bool)
    v[: p.n] = p.valid
    return p, b.reshape(-1, block), v.reshape(-1, block)


def _both(seq, kmers, k, w, block=512, **kw):
    """(port's outputs, JAX's outputs) as numpy, positions trimmed to n."""
    p, b2, v2 = _blocked(seq, block)
    tracked = np.array([kmer_to_code(x) for x in kmers], dtype=np.int32)
    codes, kv = blocked.blocked_codes(torch.from_numpy(b2).to(torch.int32),
                                      torch.from_numpy(v2), k)
    codes = torch.where(kv, codes, 0)
    got = window.windowed_counts_device(
        codes, kv, torch.from_numpy(v2), torch.from_numpy(tracked), k, w,
        with_positions=True, **kw)
    rc, rkv = ref_blocked.blocked_codes(jnp.asarray(b2, jnp.int32),
                                        jnp.asarray(v2), k)
    rc = jnp.where(rkv, rc, 0)
    want = ref_wcd(rc, rkv, jnp.asarray(v2), jnp.asarray(tracked), k, w,
                   with_positions=True, **kw)
    got = [g.numpy() for g in got]
    want = [np.asarray(x) for x in want]
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape
    return p, got, want


def test_hand_trace_equals_jax():
    names = ["CG", "GC", "CC", "CA", "AA", "AT", "TG"]
    expect = {"CG": (3, 2), "GC": (1, 4), "CC": (2, 3), "CA": (1, 4),
              "AA": (0, 5), "AT": (1, 4), "TG": (2, 3)}
    _, got, want = _both("CGCCAATGCG", names, 2, 6)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    dist, cpos, _ = got
    for i, nm in enumerate(names):
        assert tuple(dist[:2, i]) == expect[nm], nm
    assert list(cpos[0][:5]) == [1, 0, 0, 0, 1]  # CG per-window counts


@pytest.mark.parametrize("seed", range(3))
def test_random_equals_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 6000, n_prob=0.01)
    kmers = ["ACG", "TTT", "GAG"]
    k, w = 3, 24
    p, got, want = _both(seq, kmers, k, w)
    for g, x in zip(got, want):
        assert np.array_equal(g, x)
    tracked = np.array([kmer_to_code(x) for x in kmers])
    oracle_pos = np.zeros((len(seq), len(kmers)), dtype=np.int64)
    oracle_dist = windowed_distributions(seq, tracked, k, w,
                                         counts_pos=oracle_pos)
    assert np.array_equal(got[0], oracle_dist)
    assert np.array_equal(got[1][:, :p.n].T, oracle_pos)


def test_start_limit_equals_jax():
    rng = np.random.default_rng(11)
    seq = random_seq(rng, 5000, n_prob=0.005)
    for limit in (0, 1, 2047, 3000, 5120):
        _, got, want = _both(seq, ["AC", "GG"], 2, 30, start_limit=limit)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), limit
        assert not got[2][limit:].any()


def test_groups_of_starts_equal_one_group(monkeypatch):
    """Window starts in groups (each reading a window-base lookahead, one
    K3 launch each) give the counts of one group."""
    rng = np.random.default_rng(4)
    seq = random_seq(rng, 9000, n_prob=0.004)
    _, one, want = _both(seq, ["CG", "TA", "AC"], 2, 50)
    monkeypatch.setattr(window, "GROUP", 777)
    launches = []
    plain = histogram.histogram_plain
    monkeypatch.setattr(histogram, "histogram",
                        lambda *a: launches.append(1) or plain(*a))
    _, got, _ = _both(seq, ["CG", "TA", "AC"], 2, 50)
    assert len(launches) == -(-9216 // 777)
    for g, o, w in zip(got, one, want):
        assert np.array_equal(g, o) and np.array_equal(g, w)


def test_short_input_has_no_valid_window():
    p, got, want = _both("ACGTACGTAC", ["AC"], 2, 20)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not got[0].any() and not got[2].any()


def _nbases(seq):
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return p, nb


def test_streaming_engine_equals_jax_and_oracle():
    """Chunks with a window lookahead and packed positions: dist and
    per-position counts equal JAX's engine and the oracle across chunk
    boundaries and N gaps, for sequences shorter and longer than the
    chunk."""
    rng = np.random.default_rng(3)
    k, w = 2, 20
    kmers = ["CG", "GC", "AT"]
    tracked = np.array([kmer_to_code(x) for x in kmers], dtype=np.int32)
    eng = window_stream.StreamingWindowEngine(k, w, len(tracked),
                                              chunk=8192, block=512,
                                              device="cpu")
    ref = ref_stream.StreamingWindowEngine(k, w, len(tracked), chunk=8192,
                                           block=512)
    assert eng._pos_dtype == torch.uint8 and ref._pos_dtype == np.uint8
    for n in (5_000, 8192, 30_000):  # below, exactly, and above the chunk
        p, nb = _nbases(random_seq(rng, n, n_prob=0.01))
        dist, cpos = eng.run(eng.stage(nb), n, tracked,
                             with_positions=True)
        want_d, want_c = ref.run(nb, tracked, with_positions=True)
        assert dist.dtype == cpos.dtype == np.int64
        assert np.array_equal(dist, want_d) and np.array_equal(cpos, want_c)
        o_d = np.zeros((w + 1, len(kmers)), dtype=np.int64)
        o_c = np.zeros((p.n, len(kmers)), dtype=np.int64)
        windowed_distributions(p, tracked.astype(np.int64), k, w, o_d, o_c)
        assert np.array_equal(dist, o_d) and np.array_equal(cpos, o_c), n
        d2, none = eng.run(eng.stage(torch.from_numpy(nb)), n, tracked,
                           with_positions=False)
        assert none is None and np.array_equal(d2, dist)


def test_streaming_engine_int16_positions():
    """window + 2 > 255 switches the packed positions to int16."""
    rng = np.random.default_rng(5)
    k, w = 1, 300
    tracked = np.array([kmer_to_code("A")], dtype=np.int32)
    eng = window_stream.StreamingWindowEngine(k, w, 1, chunk=8192,
                                              block=512, device="cpu")
    assert eng._pos_dtype == torch.int16
    p, nb = _nbases("A" * 700 + random_seq(rng, 10_000))
    dist, cpos = eng.run(eng.stage(nb), p.n, tracked, with_positions=True)
    want_d, want_c = ref_stream.StreamingWindowEngine(
        k, w, 1, chunk=8192, block=512).run(nb, tracked, with_positions=True)
    assert np.array_equal(dist, want_d) and np.array_equal(cpos, want_c)
    assert int(cpos.max()) > 255  # counts genuinely exceed uint8


def test_get_engine_caches_per_shape():
    a = window_stream.get_engine(2, 40, 3, 1 << 15, 8192, torch.device("cpu"))
    b = window_stream.get_engine(2, 40, 3, 1 << 15, 8192, torch.device("cpu"))
    c = window_stream.get_engine(2, 40, 4, 1 << 15, 8192, torch.device("cpu"))
    assert a is b and a is not c
    with pytest.raises(ValueError):
        window_stream.StreamingWindowEngine(2, 40, 3, chunk=1000, block=512,
                                            device="cpu")


def test_cohort_mode_equals_per_sequence_and_jax():
    """seg2d/n_seqs (one call for a scaffold cohort) equals one call per
    scaffold, and the JAX package's cohort mode."""
    rng = np.random.default_rng(99)
    k, w, B = 2, 40, 256
    tracked = np.arange(16, dtype=np.int32)
    lens = [1000, 3000, 513, 2048]
    seqs = [rng.integers(0, 4, size=L, dtype=np.uint8) for L in lens]
    seqs[1][100:130] = 4  # interior N run
    total = sum(lens) + len(lens) - 1
    npad = -(-total // B) * B
    cat = np.full(npad, 4, np.uint8)
    seg = np.zeros(npad, np.int32)
    pos = 0
    for i, s in enumerate(seqs):
        if i:
            pos += 1
        cat[pos:pos + len(s)] = s
        seg[pos:] = i
        pos += len(s)
    b2, v2 = (cat & 3).reshape(-1, B), (cat < 4).reshape(-1, B)
    codes, kv = blocked.blocked_codes(torch.from_numpy(b2).to(torch.int32),
                                      torch.from_numpy(v2), k)
    multi, _, _ = window.windowed_counts_device(
        codes, kv, torch.from_numpy(v2), torch.from_numpy(tracked), k, w,
        seg2d=torch.from_numpy(seg.reshape(-1, B)), n_seqs=len(seqs))
    multi = multi.numpy()
    assert multi.shape == (len(seqs), w + 1, 16) and multi.dtype == np.int32
    rc, rkv = ref_blocked.blocked_codes(jnp.asarray(b2, jnp.int32),
                                        jnp.asarray(v2), k)
    want, _, _ = ref_wcd(rc, rkv, jnp.asarray(v2), jnp.asarray(tracked), k, w,
                         seg2d=jnp.asarray(seg.reshape(-1, B)),
                         n_seqs=len(seqs))
    assert np.array_equal(multi, np.asarray(want))
    for i, s in enumerate(seqs):
        one = np.full(-(-len(s) // B) * B, 4, np.uint8)
        one[:len(s)] = s
        b1, v1 = (one & 3).reshape(-1, B), (one < 4).reshape(-1, B)
        c1, kv1 = blocked.blocked_codes(torch.from_numpy(b1).to(torch.int32),
                                        torch.from_numpy(v1), k)
        d1, _, _ = window.windowed_counts_device(
            c1, kv1, torch.from_numpy(v1), torch.from_numpy(tracked), k, w)
        assert np.array_equal(multi[i], d1.numpy()), i


def test_dist_values_bins():
    cnt = torch.tensor([[0, 3, 5], [2, 2, 0]], dtype=torch.int32)
    wv = torch.tensor([True, False, True])
    values, valid, size = window.dist_values(cnt, wv, 6)
    assert size == 128 and values.tolist() == [[0, 3, 5], [10, 10, 8]]
    assert valid.is_contiguous() and valid.tolist() == [[True, False, True]] * 2
    seg = torch.tensor([0, 1, 4], dtype=torch.int32)
    values, _, size = window.dist_values(cnt, wv, 200, seg, 154)
    assert size == -(-154 * 2 * 202 // 128) * 128
    assert values[:, 2].tolist() == [4 * 404 + 5, 4 * 404 + 202]


@pytest.mark.parametrize("k", [1, 2, 5])
def test_blocked_codes_halo_equals_jax(k):
    """first_bases / first_valid seed row 0's halo as in the reference; the
    default (None) keeps the genome-start halo bit for bit."""
    rng = np.random.default_rng(k)
    b = rng.integers(0, 4, (6, 64)).astype(np.int32)
    v = rng.random((6, 64)) < 0.95
    hb = rng.integers(0, 4, k - 1).astype(np.int32)
    hv = np.ones(k - 1, bool)
    if k > 2:
        hv[0] = False
    for first in ((None, None), (hb, hv)):
        got = blocked.blocked_codes(
            torch.from_numpy(b), torch.from_numpy(v), k,
            first_bases=None if first[0] is None else torch.from_numpy(
                first[0]),
            first_valid=None if first[1] is None else torch.from_numpy(
                first[1]))
        want = ref_blocked.blocked_codes(
            jnp.asarray(b), jnp.asarray(v), k,
            first_bases=None if first[0] is None else jnp.asarray(first[0]),
            first_valid=None if first[1] is None else jnp.asarray(first[1]))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    plain = blocked.blocked_codes(torch.from_numpy(b), torch.from_numpy(v), k)
    zero = blocked.blocked_codes(
        torch.from_numpy(b), torch.from_numpy(v), k,
        first_bases=torch.zeros(k - 1, dtype=torch.int32),
        first_valid=torch.zeros(k - 1, dtype=torch.bool))
    for p_, z in zip(plain, zero):
        assert torch.equal(p_, z)


def test_windowed_distributions_copy_equals_the_reference():
    rng = np.random.default_rng(8)
    seq = random_seq(rng, 4000, n_prob=0.01)
    tracked = np.array([kmer_to_code(x) for x in ("AC", "GT", "CC")])
    got_c = np.zeros((len(seq), 3), np.int64)
    want_c = np.zeros((len(seq), 3), np.int64)
    got = windowed_distributions(seq, tracked, 2, 30, counts_pos=got_c)
    want = ref_oracle_wd(seq, tracked, 2, 30, counts_pos=want_c)
    assert np.array_equal(got, want) and np.array_equal(got_c, want_c)


def _flats(seed, n, k, T, S=None):
    """Random flat codes, k-mer validity and base validity of n positions,
    T tracked codes (the last of them a repeat), and with S each
    position's scaffold."""
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.integers(0, 4 ** k, n).astype(np.int32))
    kv = torch.from_numpy(rng.random(n) < 0.9)
    v = torch.from_numpy(rng.random(n) < 0.98)
    tr = rng.integers(0, 4 ** k, T).astype(np.int32)
    tr[-1] = tr[0]
    seg = None if S is None else torch.from_numpy(
        np.sort(rng.integers(0, S, n)).astype(np.int32))
    return c, kv, v, torch.from_numpy(tr), seg


@pytest.mark.parametrize("want_counts", [False, True])
@pytest.mark.parametrize("S", [None, 7])
@pytest.mark.parametrize("seed", range(3))
def test_window_values_plain_route_equals_the_chain(seed, S, want_counts):
    """On a CPU tensor window_values is window_group then dist_values, and
    launches nothing."""
    k, w = 2 + seed, 9 + 11 * seed
    c, kv, v, tr, seg = _flats(seed, 3000, k, 5, S)
    lo, hi = 17 * seed, 3000 - 5 * seed
    before = window.window_counts_launches
    got = window.window_values(c, kv, v, tr, k, w, lo, hi, seg, S,
                               want_counts=want_counts)
    assert window.window_counts_launches == before
    cnt, wv = window.window_group(c, kv, v, tr, k, w, lo, hi)
    values, valid, size = window.dist_values(
        cnt, wv, w, None if seg is None else seg[lo:hi], S)
    assert got[2] == size
    for g, x in zip(got[:2] + got[3:],
                    (values, valid, wv, cnt if want_counts else None)):
        assert (g is None and x is None) or torch.equal(g, x)


def _bad(case):
    c, kv, v, tr, seg = _flats(9, 256, 2, 4, 3)
    args = dict(flat_c=c, flat_kv=kv, flat_v=v, tracked=tr, k=2, window=10,
                lo=0, hi=256, seg=seg, n_seqs=3)
    meta = torch.device("meta")
    args.update({
        "codes int64": dict(flat_c=c.long()),
        "kv uint8": dict(flat_kv=kv.to(torch.uint8)),
        "tracked int64": dict(tracked=tr.long()),
        "seg int64": dict(seg=seg.long()),
        "v shorter": dict(flat_v=v[:-1]),
        "seg shorter": dict(seg=seg[1:]),
        "codes 2-D": dict(flat_c=c.reshape(16, 16)),
        "tracked 2-D": dict(tracked=tr.reshape(2, 2)),
        "tracked elsewhere": dict(tracked=tr.to(meta)),
        "codes elsewhere": dict(flat_c=c.to(meta)),
        "all on meta": dict(flat_c=c.to(meta), flat_kv=kv.to(meta),
                            flat_v=v.to(meta), tracked=tr.to(meta),
                            seg=seg.to(meta)),
        "seg without n_seqs": dict(n_seqs=None),
        "window below k": dict(window=1),
        "starts past n": dict(hi=257),
    }[case])
    return args


@pytest.mark.parametrize("case,error", [
    ("codes int64", TypeError), ("kv uint8", TypeError),
    ("tracked int64", TypeError), ("seg int64", TypeError),
    ("v shorter", ValueError), ("seg shorter", ValueError),
    ("codes 2-D", ValueError), ("tracked 2-D", ValueError),
    ("tracked elsewhere", ValueError), ("codes elsewhere", ValueError),
    ("all on meta", ValueError), ("seg without n_seqs", ValueError),
    ("window below k", ValueError), ("starts past n", ValueError)])
def test_window_values_refuses(case, error):
    """Wrong dtypes, mismatched shapes and tensors on two devices raise
    before any work, on either route."""
    with pytest.raises(error):
        window.window_values(**_bad(case))
