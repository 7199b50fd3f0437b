"""extract_confirm_ms_per_call: the program's spans ``extract.confirm``
in spans/extract.py _candidates: the sequential walks
(``_first_nonpositive``) over the stretches whose sums did not confirm
the screen's zeros."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.seconds(run, "extract.confirm"))
