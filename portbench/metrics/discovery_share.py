"""The share of the sweeps' seconds spent discovering orders: the port's
``replay.exact`` spans with ``cause`` ``discover`` (the runs that record
an order, ``BatchStats.reference_lanes``) over its ``sweep`` spans, in
percent (:mod:`portbench.program_spans`)."""

from portbench.program_spans import share


def read(run):
    return share(run, "replay.exact", "sweep", cause="discover")
