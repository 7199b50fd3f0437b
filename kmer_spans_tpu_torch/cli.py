"""Command-line interface of the port: ``python -m kmer_spans_tpu_torch.cli``.

The subcommands and flags of ``kmer_spans_tpu/cli.py``, printing the same
text.  ``--backend`` takes ``auto`` (the default: the device path),
``host`` (the sequential oracle) or ``native`` (the host C++ library), as
the api does; ``--device`` (``cuda`` by default, or ``cpu`` for the
kernels' plain versions) is where ``auto`` runs, and stands in for the
reference's ``--backend jax``.  ``stream`` and ``windows`` have no
``--backend``, as in the reference: they run on the device.

  count    k-mer spectrum of FASTA input (optionally write .bin spectrum)
  spans    low-complexity / repeat span calling
  stream   span calling through the chunked streaming pipeline
  wide     span calling at wide k (16..23; sparse spectrum)
  regions  arbitrary-weight span calling from a scores TSV
  windows  sliding-window k-mer occurrence distributions
  kmers    print all 4^k k-mers in 2-bit index order
  lr       transition-score region calling
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_seqs(path, min_l=0):
    from .io.fasta import read_fasta

    records = read_fasta(path)
    names = [n for n, s in records if len(s) >= min_l]
    seqs = [s for _, s in records if len(s) >= min_l]
    if not seqs:
        sys.exit(f"no sequences (>= {min_l} bases) in {path}")
    return names, seqs


def _add_common(sp):
    sp.add_argument("fasta", help="FASTA file (plain or .gz)")
    sp.add_argument("-k", type=int, default=8)
    sp.add_argument("--backend", default="auto",
                    choices=["auto", "host", "native"],
                    help="auto: the device path on --device; host: the "
                    "sequential oracle; native: the host C++ library")
    _add_device(sp)


def _add_device(sp):
    sp.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")


def _write_regions(regions, name_of):
    w = sys.stdout
    w.write("seq\tbeg\tend\tscore\n")
    for r in regions:
        w.write(f"{name_of(r['seq_id'])}\t{r['beg']}\t{r['end']}\t"
                f"{r['score']:.6f}\n")


def cmd_count(args):
    from . import api

    names, seqs = _load_seqs(args.fasta, args.min_l)
    res = api.kmer_counts(seqs, args.k, device=args.device,
                          backend=args.backend)
    if args.out:
        from .io.spectrum_file import write_kmers

        write_kmers(args.out, [res.counts])
        print(f"wrote {args.out} (k={args.k}, n={int(res.n)})")
    else:
        from .encoding import code_to_kmer

        top = np.argsort(res.counts)[::-1][: args.top]
        print(json.dumps({
            "k": args.k,
            "n": res.n,
            "top": {code_to_kmer(int(c), args.k): int(res.counts[c])
                    for c in top},
        }))


def cmd_spans(args):
    from . import api

    names, seqs = _load_seqs(args.fasta, args.min_l)
    if args.scoring == "rank":
        res = api.kmer_low_comp_regions(
            seqs, args.k, args.min_width, args.min_score, thr=args.thr,
            device=args.device, backend=args.backend,
        )
    else:
        res = api.kmer_spans(
            seqs, args.k, scoring=args.scoring, min_width=args.min_width,
            min_score=args.min_score, thr=args.thr, f_t=args.f_t,
            device=args.device, backend=args.backend,
        )
    _write_regions(res.regions, lambda i: names[i])
    print(f"# {len(res.regions)} regions, {int(res.n[0])} k-mers counted",
          file=sys.stderr)


def cmd_stream(args):
    """Span-call a large FASTA through the chunked streaming pipeline;
    with --metrics, inside the span recorder, whose span counts, self
    seconds and counters join the phases' JSON on stderr."""
    from .utils import metrics

    if not args.metrics:
        _stream(args)
        return
    with metrics.tracing() as rec:
        phases = _stream(args)
    print(phases.dump(rec), file=sys.stderr)


def _stream(args):
    """cmd_stream's work; returns its phases' Metrics."""
    from .encoding import pack
    from .io.fasta import read_fasta
    from .parallel.stream import StreamingSpanPipeline
    from .utils.metrics import Metrics

    records = read_fasta(args.fasta)
    if not records:
        sys.exit(f"no sequences in {args.fasta}")

    def nbases_of(seq):
        p = pack(seq)
        nb = p.bases.copy()
        nb[~p.valid] = 4
        return nb

    # one pipeline for every scaffold (the same chunk shape); the spectrum
    # accumulates over all scaffolds before any scan, as the reference's
    # does (src/kmer_spans.c:592)
    pipe = StreamingSpanPipeline(
        args.k, chunk_bases=args.chunk, block=args.block,
        cand_blocks=args.cand_blocks, device=args.device,
    )
    metrics = Metrics()
    kept = [(si, name, seq) for si, (name, seq) in enumerate(records)
            if len(seq) >= args.k]

    def chunks_of(seq):
        nb = nbases_of(seq)

        def factory():
            for i in range(0, len(nb), args.chunk):
                yield nb[i: i + args.chunk]

        return factory

    with metrics.phase("count"):
        acc = None
        for si, name, seq in kept:
            acc = pipe.accumulate_counts(chunks_of(seq), acc=acc)
    with metrics.phase("rank"):
        mass, total = pipe.finish_rank(acc)
        model = None
        if args.scoring == "threshold":
            from .models.scoring import ThresholdScoring

            model = ThresholdScoring(pipe._counts_host, args.f_t)
        elif args.scoring == "log2med":
            from .models.scoring import Log2MedianScoring

            model = Log2MedianScoring(pipe._counts_host)
    sys.stdout.write("seq\tbeg\tend\tscore\n")
    total_regions = total_unresolved = 0
    for si, name, seq in kept:
        ckpt = f"{args.checkpoint}.{si}" if args.checkpoint else None
        res = pipe.scan_stream(
            chunks_of(seq), mass, total, args.thr, args.min_width,
            args.min_score, seq_id=si, checkpoint_path=ckpt,
            resume=args.resume, metrics=metrics, model=model,
        )
        for sid, beg, end, score in res.regions:
            sys.stdout.write(f"{name}\t{beg}\t{end}\t{score:.6f}\n")
        total_regions += len(res.regions)
        total_unresolved += len(res.unresolved)
    print(f"# {total_regions} regions, {total} k-mers, "
          f"{total_unresolved} unresolved windows", file=sys.stderr)
    return metrics


def cmd_wide(args):
    from . import api

    names, seqs = _load_seqs(args.fasta, args.min_l)
    res = api.kmer_wide_regions(
        seqs, args.k, args.min_width, args.min_score, thr=args.thr,
        device=args.device, backend=args.backend)
    _write_regions(res.regions, lambda i: names[i])
    print(f"# {len(res.regions)} regions, {res.n_words} k-mers, "
          f"{len(res.spectrum_codes)} distinct (sparse spectrum)",
          file=sys.stderr)


def cmd_regions(args):
    from . import api

    names, seqs = _load_seqs(args.fasta, 0)
    scores = {}
    with open(args.scores) as fh:
        for line in fh:
            if line.strip():
                kmer, val = line.split()
                scores[kmer] = float(val)
    res = api.kmer_regions(
        seqs, args.k, scores, args.min_width, args.min_score,
        device=args.device, backend=args.backend,
    )
    _write_regions(res.regions, lambda i: names[i])


def cmd_windows(args):
    from . import api

    names, seqs = _load_seqs(args.fasta, 0)
    res = api.window_kmer_dist(
        seqs, args.kmers.split(","), args.window, freq=not args.counts,
        device=args.device,
    )
    sys.stdout.write("count\t" + "\t".join(res.kmers) + "\n")
    for i in range(res.dist.shape[0]):
        row = res.dist[i]
        if not row.any():
            continue
        vals = "\t".join(
            f"{v:.6g}" if not args.counts else str(int(v)) for v in row
        )
        sys.stdout.write(f"{i}\t{vals}\n")


def cmd_kmers(args):
    from .encoding import all_kmers

    for s in all_kmers(args.k):
        print(s)


def cmd_lr(args):
    """Transition-score (Markov log-likelihood-ratio) region calling."""
    from . import api

    names, seqs = _load_seqs(args.fasta, 0)
    kmers, ks, ts = [], [], []
    with open(args.scores) as fh:
        for line in fh:
            if line.strip():
                kmer, seed, trans = line.split()
                kmers.append(kmer)
                ks.append(float(seed))
                ts.append(float(trans))
    res = api.lr_regions(seqs, (args.k, args.min_length), kmers, ks, ts,
                         device=args.device, backend=args.backend)
    _write_regions(res.regions, lambda i: names[i - 1])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="kmer-spans-torch",
        description="k-mer span-finding engine on PyTorch + CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("count", help="k-mer spectrum")
    _add_common(sp)
    sp.add_argument("--out", help="write binary spectrum file (magic 310572)")
    sp.add_argument("--min-l", type=int, default=0)
    sp.add_argument("--top", type=int, default=10)
    sp.set_defaults(fn=cmd_count)

    sp = sub.add_parser("spans", help="low-complexity/repeat span calling")
    _add_common(sp)
    sp.add_argument("--scoring", default="rank",
                    choices=["rank", "threshold", "log2_median"])
    sp.add_argument("--thr", type=float, default=0.75)
    sp.add_argument("--f-t", type=float, default=None,
                    help="frequency threshold (scoring=threshold)")
    sp.add_argument("--min-width", type=int, default=100)
    sp.add_argument("--min-score", type=float, default=20.0)
    sp.add_argument("--min-l", type=int, default=0)
    sp.set_defaults(fn=cmd_spans)

    sp = sub.add_parser(
        "stream", help="chunked streaming span calling for large genomes")
    sp.add_argument("fasta")
    sp.add_argument("-k", type=int, default=8)
    _add_device(sp)
    sp.add_argument("--thr", type=float, default=0.75)
    sp.add_argument("--min-width", type=int, default=100)
    sp.add_argument("--min-score", type=float, default=20.0)
    sp.add_argument("--chunk", type=int, default=1 << 25)
    sp.add_argument("--block", type=int, default=8192)
    sp.add_argument("--cand-blocks", type=int, default=128)
    sp.add_argument("--checkpoint", default=None,
                    help="save/resume scan state per chunk")
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--metrics", action="store_true",
                    help="print per-phase metrics JSON to stderr")
    sp.add_argument("--scoring", choices=["rank", "threshold", "log2med"],
                    default="rank",
                    help="scoring model for the streamed scan")
    sp.add_argument("--f-t", type=float, default=1e-4,
                    help="frequency threshold for --scoring threshold")
    sp.set_defaults(fn=cmd_stream)

    sp = sub.add_parser(
        "wide", help="span calling at wide k (16..23; sparse spectrum)")
    _add_common(sp)
    sp.add_argument("--thr", type=float, default=0.75)
    sp.add_argument("--min-width", type=int, default=100)
    sp.add_argument("--min-score", type=float, default=20.0)
    sp.add_argument("--min-l", type=int, default=0)
    sp.set_defaults(fn=cmd_wide)

    sp = sub.add_parser("regions", help="arbitrary-weight span calling")
    _add_common(sp)
    sp.add_argument("--scores", required=True,
                    help="TSV of kmer<TAB>score, all 4^k kmers")
    sp.add_argument("--min-width", type=int, default=10)
    sp.add_argument("--min-score", type=float, default=5.0)
    sp.set_defaults(fn=cmd_regions)

    sp = sub.add_parser("windows", help="windowed k-mer distributions")
    sp.add_argument("fasta")
    _add_device(sp)
    sp.add_argument("--kmers", required=True, help="comma-separated k-mers")
    sp.add_argument("--window", type=int, required=True)
    sp.add_argument("--counts", action="store_true",
                    help="raw counts instead of frequencies")
    sp.set_defaults(fn=cmd_windows)

    sp = sub.add_parser("kmers", help="all 4^k k-mers in index order")
    sp.add_argument("-k", type=int, default=2)
    sp.set_defaults(fn=cmd_kmers)

    sp = sub.add_parser("lr", help="transition-score region calling")
    _add_common(sp)
    sp.add_argument("--scores", required=True,
                    help="TSV of kmer<TAB>seed_score<TAB>trans_score "
                         "(all 4^k kmers, any order)")
    sp.add_argument("--min-length", type=int, default=100)
    sp.set_defaults(fn=cmd_lr)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
