"""finish_self_ms_per_call: the program's span ``finish.weight``
(spans/finish.py finish_weight_spans) less its child spans: candidacy
(compose_summaries_exact, the run-max mask over the blocks) and the
loop's glue, extract_spans's own work included."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    return program.per_call(run, program.self_seconds(run, "finish.weight"))
