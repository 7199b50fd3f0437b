"""extract_screen_ms_per_call: the program's spans ``extract.screen`` in
spans/extract.py _candidates: the vectorized screen's zeros and the
stretches' sequential sums (``_segment_sums``) of each range."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.seconds(run, "extract.screen"))
