"""The share of the window's candidates that the replay protocol finished
in lockstep on the card: ``lockstep_lanes`` (``Explorer.batch_stats``)
over the candidates of the window's answered sweeps, in percent.  The
rest ran the host's exact path: discovered (``reference_lanes``), in a
group under ``MIN_LOCKSTEP`` or pinned to an order of their own."""


def read(run):
    done = [a for a in run["answers"] if a["ok"] and "batch_stats" in a]
    lanes = sum(len(a["expected"]) for a in done)
    if lanes == 0:
        return None
    return 100.0 * sum(a["batch_stats"]["lockstep_lanes"]
                       for a in done) / lanes
