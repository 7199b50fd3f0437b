"""extract_replay_ms_per_call: the program's spans ``extract.replay`` in
spans/extract.py extract_segment_spans: each candidate excursion's
sequential f64 replay and its first argmax."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.seconds(run, "extract.replay"))
