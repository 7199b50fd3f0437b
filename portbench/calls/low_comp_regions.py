"""Configurations whose ``call`` is ``low_comp_regions``: the program's
``kmer_low_comp_regions`` on one assembly a call, and the comparison of
what it returns with the plain reference (reference/low_comp_regions.py).

Every number compared is exact, so every limit is 0: the spectrum and n
are integers, the weights are the reference's f64 rank chain and the
regions' f64 scores are bit-identical to the C reference by the
configuration's guarantee.
"""

from __future__ import annotations

import numpy as np

from reference import low_comp_regions as reference_impl

#: (name, limit) of each number compared, in the order printed
CHECKS = (("spectrum_entries_wrong", 0), ("weights_entries_wrong", 0),
          ("regions_wrong", 0))


def program_input(assembly) -> list:
    """The assembly as the program takes it: a PackedSeq a sequence, the
    form io/fasta.read_fasta_packed returns."""
    from kmer_spans_tpu_torch.encoding import PackedSeq
    return [PackedSeq(bases=b, valid=v)
            for b, v in zip(assembly.bases, assembly.valid)]


def run(api, seqs, config: dict, device):
    return api.kmer_low_comp_regions(
        seqs, config["k"], config["min_w"], config["min_score"],
        thr=config["thr"], mode=config["mode"], device=device)


def answer(result) -> dict:
    """The parts of a result that are compared."""
    r = result.regions
    regions = np.zeros(r.shape[0], reference_impl.REGION_DTYPE)
    for f in ("seq_id", "beg", "end", "score"):
        regions[f] = r[f]
    return {"counts": np.asarray(result.counts),
            "n": np.asarray(result.n, np.float64),
            "w_rank": np.asarray(result.w_rank), "regions": regions}


def reference(assembly, config: dict, dtype=np.float64, workers: int = 1,
              device="cpu"):
    """The reference's answer on the same bases, in ``dtype``."""
    want = reference_impl.low_comp_regions(
        list(zip(assembly.bases, assembly.valid)), config["k"],
        config["min_w"], config["min_score"], config["thr"], dtype, workers,
        device)
    return {"counts": want["counts"],
            "n": np.array([want["n"], 0.0]),  # slot 1 is always 0
            "w_rank": want["w_rank"].astype(np.float64),
            "regions": want["regions"]}


def size(want: dict) -> str:
    """What the reference's answer holds, in a few words."""
    return f"{want['regions'].shape[0]} regions"


def _unequal(got: np.ndarray, want: np.ndarray) -> int:
    """Entries that differ, and every entry of a length that differs."""
    if got.shape != want.shape:
        return max(got.size, want.size)
    return int(np.count_nonzero(got != want))


def compare(got: dict, want: dict) -> dict:
    """{name: value} of each number compared, for one answer."""
    g, w = got["regions"], want["regions"]
    # regions in one answer and not the other, or else out of order
    regions_wrong = len(set(g.tolist()) ^ set(w.tolist()))
    if regions_wrong == 0:
        regions_wrong = _unequal(g, w)
    return {
        "spectrum_entries_wrong": _unequal(got["counts"], want["counts"])
        + _unequal(got["n"], want["n"]),
        "weights_entries_wrong": _unequal(got["w_rank"], want["w_rank"]),
        "regions_wrong": regions_wrong,
    }
