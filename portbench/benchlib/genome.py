"""The one traffic generator: seeded assemblies from a traffic file.

A traffic file (``traffic/<name>.json``) holds only parameters.  Every
mix is an assembly of ``total_bases`` bases split into ``sequences``
sequences, with this content:

  * background bases drawn independently with a G+C share of ``gc``;
  * simple tandem repeats covering ``repeat_share`` of the bases: arrays
    whose lengths are log-uniform over ``repeat_array_bases``, each of one
    unit of ``repeat_unit_bases`` bases (length uniform, bases drawn like
    the background), placed uniformly at random (a later array overwrites
    an earlier one where they overlap).  The arrays' lengths and units
    come from the file's ``repeat_seed``, their places from the run seed,
    so every assembly holds the same repeats in other places;
  * an N gap of ``n_gap_bases`` every ``n_gap_every`` bases from
    ``n_gap_first``, in the coordinates of the whole assembly.

With more than one sequence, the lengths are Pareto(``length_pareto_alpha``)
draws plus ``length_pareto_offset``, sorted longest first and scaled to
``total_bases`` in whole bases, each at least ``min_sequence_bases``.  They
come from the file's ``length_seed``, so every run seed calls the same set
of lengths and only the content changes with the seed.

Bases are the program's 2-bit codes (A 0, C 1, T 2, G 3) in uint8, with a
validity mask that is False in the gaps, where the base is 3 (the code an
'N' byte packs to).  The background is drawn with a ``torch.Generator`` on
the given device, in chunks of a fixed size, so one seed gives the same
bases on every run on that kind of device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: background bases drawn per generator call (fixed: the chunking is part
#: of what a seed means)
_CHUNK = 1 << 26
#: resolution of the base distribution: draws are uniform over 2^16 levels
_LEVELS = 1 << 16


@dataclasses.dataclass
class Assembly:
    """One generated assembly: its sequences and what was planted in it."""

    bases: list[np.ndarray]  # uint8 per sequence, 2-bit codes
    valid: list[np.ndarray]  # bool per sequence, False in N gaps
    repeat_starts: np.ndarray  # int64, assembly coordinates
    repeat_lengths: np.ndarray  # int64
    repeat_units: list[np.ndarray]  # uint8 unit of each array

    @property
    def lengths(self) -> list[int]:
        return [int(b.shape[0]) for b in self.bases]

    @property
    def total(self) -> int:
        return sum(self.lengths)


def sequence_lengths(params: dict) -> np.ndarray:
    """The lengths of the sequences of every assembly of this mix."""
    total = int(params["total_bases"])
    count = int(params["sequences"])
    if count == 1:
        return np.array([total], np.int64)
    rng = np.random.default_rng(int(params["length_seed"]))
    raw = np.sort(rng.pareto(float(params["length_pareto_alpha"]), count)
                  + float(params["length_pareto_offset"]))[::-1]
    floor = int(params["min_sequence_bases"])
    lengths = np.maximum((raw / raw.sum() * total).astype(np.int64), floor)
    lengths[0] += total - int(lengths.sum())  # the longest takes the rest
    if lengths[0] < lengths[1] or floor * count > total:
        raise ValueError("the traffic file's lengths do not fit its total")
    return lengths


def base_table(gc: float) -> np.ndarray:
    """uint8 [2^16]: uniform 16-bit draws to bases, A and T each with
    (1 - gc) / 2 of the levels, C and G each with gc / 2."""
    at = round(_LEVELS * (1.0 - gc) / 2)
    cg = (_LEVELS - 2 * at) // 2
    edges = np.cumsum([at, cg, at])  # A 0, C 1, T 2, then G 3
    return np.searchsorted(edges, np.arange(_LEVELS),
                           side="right").astype(np.uint8)


def make_assembly(params: dict, seed: int, index: int,
                  device="cpu") -> Assembly:
    """Assembly ``index`` of the pool of run seed ``seed``."""
    total = int(params["total_bases"])
    gc = float(params["gc"])
    state = np.random.SeedSequence([int(seed), int(index)])
    torch_seed, np_seed = state.generate_state(2, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(torch_seed))
    table_np = base_table(gc)
    table = torch.from_numpy(table_np).to(device)
    bases = np.empty(total, np.uint8)
    for s in range(0, total, _CHUNK):
        e = min(s + _CHUNK, total)
        draw = torch.randint(0, _LEVELS, (e - s,), generator=gen,
                             device=device, dtype=torch.int32)
        bases[s:e] = table[draw].cpu().numpy()
        del draw

    # tandem repeat arrays until they cover the share
    shapes = np.random.default_rng(int(params["repeat_seed"]))
    lo, hi = (float(x) for x in params["repeat_array_bases"])
    want = float(params["repeat_share"]) * total
    lens = []
    covered = 0
    while covered < want:
        n = int(round(np.exp(shapes.uniform(np.log(lo), np.log(hi)))))
        lens.append(n)
        covered += n
    lens = np.array(lens, np.int64)
    ulo, uhi = (int(x) for x in params["repeat_unit_bases"])
    ulens = shapes.integers(ulo, uhi + 1, lens.shape[0])
    units = np.split(
        table_np[shapes.integers(0, _LEVELS, int(ulens.sum()))],
        np.cumsum(ulens)[:-1])
    starts = np.random.default_rng(int(np_seed)).integers(
        0, total - lens + 1)
    if lens.shape[0]:
        pos = np.repeat(starts - np.cumsum(lens) + lens, lens) \
            + np.arange(int(lens.sum()))  # every planted position
        phase = np.arange(int(lens.sum())) - np.repeat(
            np.cumsum(lens) - lens, lens)
        uid = np.repeat(np.arange(lens.shape[0]), lens)
        flat = np.zeros((lens.shape[0], uhi), np.uint8)
        for i, u in enumerate(units):
            flat[i, :u.shape[0]] = u
        bases[pos] = flat[uid, phase % ulens[uid]]

    valid = np.ones(total, bool)
    glen = int(params["n_gap_bases"])
    gaps = np.arange(int(params["n_gap_first"]), total - glen,
                     int(params["n_gap_every"]), dtype=np.int64)
    for g in gaps:
        valid[g:g + glen] = False
        bases[g:g + glen] = 3  # what pack() gives an 'N' byte

    cuts = np.cumsum(sequence_lengths(params))[:-1]
    return Assembly(bases=np.split(bases, cuts), valid=np.split(valid, cuts),
                    repeat_starts=starts, repeat_lengths=lens,
                    repeat_units=units)
