"""extract_fold_ms_per_call: the program's spans ``extract.fold`` in
spans/extract.py extract_spans: the host library's sequential f64 fold of
each candidate stretch (utils/native.py replay_scores)."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.seconds(run, "extract.fold"))
