"""The port's api.kmer_low_comp_regions against the JAX package's."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import kmer_spans_tpu_torch
from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu_torch import api

from conftest import random_seq

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_result(got, want):
    assert np.array_equal(got.regions, want.regions)  # beg/end/score exact
    assert np.array_equal(got.n, want.n)
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.w_rank, want.w_rank)


def test_golden_three_regions_equal_jax_fast(golden):
    got = api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                    mode="fast", device="cpu")
    regs = got.regions
    assert list(regs["beg"]) == [20008, 50008, 80007]
    assert list(regs["end"]) == [20600, 50900, 80400]
    assert [round(s, 6) for s in regs["score"]] == [
        137.923657, 214.364008, 96.947531]
    want = ref_api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                         backend="jax", mode="fast")
    _same_result(got, want)


@pytest.mark.parametrize("k", [4, 6])
def test_multi_sequence_equal_jax_fast(k):
    rng = np.random.default_rng(k)
    seqs = []
    for i in range(4):
        s = list(random_seq(rng, 6_000 + 1_000 * i, n_prob=0.002))
        s[1000:1600] = "CAG" * 200
        seqs.append("".join(s))
    seqs.insert(2, "ACG")  # shorter than k: skipped, keeps its seq_id
    got = api.kmer_low_comp_regions(seqs, k, 50, 8.0, thr=0.7, mode="fast",
                                    device="cpu")
    want = ref_api.kmer_low_comp_regions(seqs, k, 50, 8.0, thr=0.7,
                                         backend="jax", mode="fast")
    _same_result(got, want)
    assert set(got.regions["seq_id"]) == {0, 1, 3, 4}


def test_overflow_reruns_on_the_device(monkeypatch):
    rng = np.random.default_rng(2)
    seq = random_seq(rng, 9_000)
    seq = seq[:2000] + "TG" * 400 + seq[2800:]
    packed = ref_api._as_seq_list(seq)
    caps = []
    make = api.make_span_pipeline

    def spy(k, **kw):
        caps.append(kw["cand_blocks"])
        return make(k, **kw)

    monkeypatch.setattr(api, "make_span_pipeline", spy)
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    # a capacity of one block cannot hold the island's run: the pipeline
    # reruns with twice the capacity, on the same device, until it does
    got = api._low_comp_fast(packed, 6, 30, 3.0, 0.75, torch.device("cpu"),
                             block=1024, cand_blocks=1)
    assert caps[:2] == [1, 2] and caps == sorted(caps)
    assert api.exact_fallbacks == len(caps) - 1 >= 1
    # the same result as JAX's fast mode, which does not overflow here
    want = ref_api.kmer_low_comp_regions(seq, 6, 30, 3.0, backend="jax",
                                         mode="fast")
    _same_result(got, want)
    # and the same regions as the reference's exact host path
    host = ref_api.kmer_low_comp_regions(seq, 6, 30, 3.0, backend="host")
    assert np.array_equal(got.regions, host.regions)
    assert len(got.regions) >= 1


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py reaches the reference's oracle only through the port."""
    with open(os.path.join(_ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "kmer_spans_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "kmer_spans_tpu"}, sorted(names)


def test_unported_modes_raise(golden):
    # k = 2 and 9 run in both modes; mode="exact" (the default) runs too,
    # and equals the reference's exact device path
    for k in (2, 9):
        for mode in ("fast", "exact"):
            got = api.kmer_low_comp_regions(golden[:30_000], k, 100, 20.0,
                                            mode=mode, device="cpu")
            assert got.counts.shape == (1 << (2 * k),)
    got = api.kmer_low_comp_regions(golden, 8, 100, 20.0, mode="exact",
                                    device="cpu")
    want = ref_api.kmer_low_comp_regions(golden, 8, 100, 20.0, mode="exact",
                                         backend="jax")
    _same_result(got, want)
    for mode in ("fast", "exact"):
        for k in (0, 16):
            with pytest.raises(ValueError):
                api.kmer_low_comp_regions(golden, k, 100, 20.0, mode=mode,
                                          device="cpu")
        with pytest.raises(ValueError):
            api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=1.5,
                                      mode=mode, device="cpu")
    with pytest.raises(ValueError):
        api.kmer_low_comp_regions(golden, 1, 100, 20.0, mode="fast",
                                  device="cpu")


@pytest.mark.parametrize("k", [3, 9])
def test_class_screen_k_equal_jax_fast_and_host(golden, k):
    """k = 9 and k = 3 go through the non-fused class screen (K3, K4)."""
    thr = 0.75 if k == 9 else 0.8
    got = api.kmer_low_comp_regions(golden, k, 100, 20.0, thr=thr,
                                    mode="fast", device="cpu")
    want = ref_api.kmer_low_comp_regions(golden, k, 100, 20.0, thr=thr,
                                         backend="jax", mode="fast")
    _same_result(got, want)
    host = ref_api.kmer_low_comp_regions(golden, k, 100, 20.0, thr=thr,
                                         backend="host")
    assert np.array_equal(got.regions, host.regions)
    assert len(got.regions) >= 1


def test_k1_fails_in_both_packages(golden):
    with pytest.raises(ValueError, match="k >= 2"):
        api.kmer_low_comp_regions(golden[:20_000], 1, 100, 20.0,
                                  mode="fast", device="cpu")
    # the exact path (the default) serves k = 1 in both
    got = api.kmer_low_comp_regions(golden[:20_000], 1, 100, 20.0,
                                    thr=0.5, device="cpu")
    want = ref_api.kmer_low_comp_regions(golden[:20_000], 1, 100, 20.0,
                                         thr=0.5, backend="jax")
    _same_result(got, want)
    # the reference's class table cannot pack 4^1 ranks 8 a word either
    with pytest.raises(TypeError, match="reshape"):
        ref_api.kmer_low_comp_regions(golden[:20_000], 1, 100, 20.0,
                                      backend="jax", mode="fast")


def test_cuda_without_card_raises(golden):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        api.kmer_low_comp_regions(golden, 8, 100, 20.0, device="cuda")


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules
    (in a fresh interpreter: this one has jax loaded by conftest)."""
    code = (
        "import pkgutil, sys, importlib, kmer_spans_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'kmer_spans_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 12  # every module of the slice was imported
    assert kmer_spans_tpu_torch.__version__
