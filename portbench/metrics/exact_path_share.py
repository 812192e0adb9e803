"""The share of the sweeps' seconds on the replay protocol's exact serial
path: the port's ``replay.exact`` spans (one a lane's exact run:
discovery, pinned signatures, groups under ``MIN_LOCKSTEP``, fallbacks)
over its ``sweep`` spans (``Explorer._explore``), in percent
(:mod:`portbench.program_spans`)."""

from portbench.program_spans import share


def read(run):
    return share(run, "replay.exact", "sweep")
