"""The port's k >= 10 pm pipeline against JAX's make_pm_span_pipeline and
the sequential oracle.

The packed int32 vector must equal the reference's element for element
(sizes are chosen so that every partial sum of the reference's f32 block
composition is exact, asserted, where its top-C choice equals the port's
int64 one).  The host finishers are copies, held equal to their
originals; they fold every candidate stretch in the port's host library.
Regions must equal the sequential oracle's rank chain exactly, the JAX
package's and the port's: positions and f64 scores.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.oracle import count_spectrum_sparse, find_regions
from kmer_spans_tpu.spans import pm_pipeline as ref
from kmer_spans_tpu.stats.ranks import SparseRanks
from kmer_spans_tpu_torch import oracle
from kmer_spans_tpu_torch.spans import pm_finish
from kmer_spans_tpu_torch.spans.pm_pipeline import make_pm_span_pipeline
from kmer_spans_tpu_torch.stats.ranks import SparseRanks as PortSparseRanks

from conftest import random_seq
from test_pm_pipeline import _arr, _plant
from test_span_pipeline import _chain_rank_regions
from test_torch_span_pipeline import _f32_exact

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["jax", "oracle"])
def reference(request):
    """What the regions are held to: the JAX package's (its oracle, or
    its finisher on the same outputs), or the port's sequential
    oracle."""
    return request.param


def _port_oracle_regions(seq, k, thr, min_w, min_s):
    """The port's oracle over the sparse spectrum (the dense chain's
    values at the present codes; no 4^k table)."""
    ucodes, ucounts, _ = oracle.count_spectrum_sparse(seq, k)
    return oracle.find_regions(seq, 0, min_w, min_s,
                               PortSparseRanks(ucodes, ucounts), k, thr)


def _genome(k, seed, n=50_000):
    rng = np.random.default_rng(seed)
    return _plant(
        random_seq(rng, n, n_prob=0.003),
        [(6000, "AG", 300), (20000, "CCTGA", 130), (41000, "T", 500)],
    )


def _port_vector(seq, k, block=1024, cand=32, **kw):
    arr, n = _arr(seq, block)
    fn, meta = make_pm_span_pipeline(k, block=block, cand_blocks=cand,
                                     device="cpu", **kw)
    vec = fn(arr, 0.75)
    return vec, arr, n, meta


@pytest.mark.parametrize("k", [10, 12, 13, 15])
def test_packed_vector_matches_jax(k):
    # 12 blocks: the reference's f32 composition stays exact (asserted)
    rng = np.random.default_rng(600 + k)
    seq = _plant(random_seq(rng, 12_000, n_prob=0.003),
                 [(2000, "AG", 300), (7000, "CCTGA", 130)])
    vec, arr, n, meta = _port_vector(seq, k, cand=5)
    fn, ref_meta = ref.make_pm_span_pipeline(k, block=1024, cand_blocks=5)
    want = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.75)))
    assert meta == ref_meta
    out = ref.unpack_pm_outputs(want, n, ref_meta)
    assert _f32_exact(out)
    assert vec.dtype == torch.int32
    assert np.array_equal(vec.numpy(), want)


@pytest.mark.parametrize("k", [10, 12, 13])
def test_regions_match_oracle(k, reference):
    seq = _genome(k, 400 + k)
    vec, _, n, meta = _port_vector(seq, k)
    out = pm_finish.unpack_pm_outputs(vec.numpy(), n, meta)
    res = pm_finish.finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert not res.fallback
    expect = (_chain_rank_regions if reference == "jax"
              else _port_oracle_regions)(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]  # f64 scores bit-identical


def test_regions_match_oracle_k15_smallv(reference):
    k = 15
    rng = np.random.default_rng(77)
    seq = _plant(
        random_seq(rng, 60_000, n_prob=0.002),
        [(8000, "AG", 400), (30000, "GATTACA", 150)],
    )
    vec, _, n, meta = _port_vector(seq, k)
    out = pm_finish.unpack_pm_outputs(vec.numpy(), n, meta)
    assert out["t_list"] >= 4  # smallv, n-adaptive threshold
    res = pm_finish.finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert not res.fallback
    # the sparse oracle: the same exact f64 chain over present codes
    if reference == "jax":
        ucodes, ucounts, _ = count_spectrum_sparse(seq, k)
        expect = find_regions(seq, 0, 30, 5.0, SparseRanks(ucodes, ucounts),
                              k, 0.75)
    else:
        expect = _port_oracle_regions(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


@pytest.mark.parametrize("k,strategy", [(12, None), (13, "packed"),
                                        (15, None)])
def test_finishers_equal_reference(k, strategy, reference):
    seq = _genome(k, 500 + k)
    vec, _, n, meta = _port_vector(seq, k, strategy=strategy)
    v = vec.numpy()
    got = pm_finish.unpack_pm_outputs(v, n, meta)
    want = ref.unpack_pm_outputs(v, n, meta)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    tables = pm_finish._pm_host_tables(got, got["t_list"])
    for g, w in zip(tables, ref._pm_host_tables(want, want["t_list"])):
        assert np.array_equal(g, w)
    for cand in (None, 1):  # all candidates pulled; a missed candidate
        o = got if cand is None else dict(got, top_idx=got["top_idx"][:1])
        g = pm_finish.finish_pm_spans(o, n, meta, 0.75, 30, 5.0)
        if reference == "jax":
            w = ref.finish_pm_spans(o, n, meta, 0.75, 30, 5.0)
            assert (g.regions, g.fallback) == (w.regions, w.fallback)
        elif cand is None:
            assert g.regions == _port_oracle_regions(seq, k, 0.75, 30, 5.0)
        else:
            assert g.regions == []
        assert g.fallback == (cand == 1)
        assert cand == 1 or len(g.regions) >= 2


def test_list_overflow_flags_fallback():
    """A too-small list capacity must flag fallback, never emit."""
    k = 12
    rng = np.random.default_rng(3)
    seq = _plant(random_seq(rng, 30_000),
                 [(2000, "A", 3000), (9000, "AG", 800),
                  (15000, "CCTGA", 300), (21000, "T", 2000)])
    vec, _, n, meta = _port_vector(seq, k, list_cap=2)
    out = pm_finish.unpack_pm_outputs(vec.numpy(), n, meta)
    assert out["list_count"] > 2
    res = pm_finish.finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert res.fallback and res.regions == []


def test_bad_arguments_raise():
    for kw in (dict(k=9), dict(k=16), dict(k=12, block=1000),
               dict(k=12, strategy="sorted")):
        with pytest.raises(ValueError):
            make_pm_span_pipeline(device="cpu", **kw)
    fn, meta = make_pm_span_pipeline(12, block=1024, device="cpu")
    with pytest.raises(ValueError):
        fn(np.zeros(1500, np.uint8), 0.75)
    with pytest.raises(TypeError):
        fn(np.zeros(1024, np.int32), 0.75)
    # the wide layout (two seed words a block, the list as (hi, lo)) is
    # decoded as the reference decodes it
    wide = dict(meta, wide=True, cand_blocks=1)
    n_words = 1 + 4 + 1 + 32 + 2 + 64 + 1024 + wide["nbins"] \
        + 3 * wide["list_cap"] + 2
    vec = np.random.default_rng(1).integers(
        -4, 1 << 20, n_words).astype(np.int32)
    got = pm_finish.unpack_pm_outputs(vec, 1024, wide)
    want = ref.unpack_pm_outputs(vec, 1024, wide)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    assert got["cand_words"].shape == (1, 2 + 1024 // 16)


def test_pm_pipeline_imports_no_jax():
    """The pm pipeline, its finisher and their imports leave jax out of
    sys.modules (in a fresh interpreter: this one has jax loaded)."""
    code = (
        "import sys\n"
        "import kmer_spans_tpu_torch.spans.pm_pipeline\n"
        "import kmer_spans_tpu_torch.spans.pm_finish\n"
        "import kmer_spans_tpu_torch.api\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
