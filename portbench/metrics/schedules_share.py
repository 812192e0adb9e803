"""The share of the sweeps' seconds spent rebuilding the top-k full
schedules: the port's ``sweep.schedules`` spans
(``Explorer._materialise_schedules``) over its ``sweep`` spans, in
percent (:mod:`portbench.program_spans`)."""

from portbench.program_spans import share


def read(run):
    return share(run, "sweep.schedules", "sweep")
