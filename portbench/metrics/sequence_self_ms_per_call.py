"""sequence_self_ms_per_call: the program's spans ``regions.sequence``
(api._call_regions, one a sequence) less their child spans: the fixed
work a sequence adds (its step's factory, buffers, the loop's glue)."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run,
                            program.self_seconds(run, "regions.sequence"))
