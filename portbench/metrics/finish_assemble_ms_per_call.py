"""finish_assemble_ms_per_call: the program's spans ``finish.assemble``,
one a candidate stretch of spans/finish.py finish_weight_spans: its
blocks' codes and flags looked up and joined, and their f64 scores
gathered from the weight table."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.seconds(run, "finish.assemble"))
