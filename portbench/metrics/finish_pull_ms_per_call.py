"""finish_pull_ms_per_call: the program's spans ``finish.pull``, one a
batch of candidate blocks that spans/finish.py finish_weight_spans pulls
beyond the step's top C (the device gather and the copy of its rows to
the host)."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.seconds(run, "finish.pull"))
