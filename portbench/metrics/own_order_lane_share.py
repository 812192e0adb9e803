"""The share of the window's candidates that the torch engine stepped
through their own heap orders on the card: ``own_order_lanes``
(``Explorer.batch_stats``, counted with ``lockstep_lanes`` too) over the
candidates of the window's answered sweeps, in percent.  None where no
sweep was answered, or where the program keeps no such counter."""


def read(run):
    done = [a for a in run["answers"] if a["ok"] and "batch_stats" in a]
    lanes = sum(len(a["expected"]) for a in done)
    if lanes == 0 or any("own_order_lanes" not in a["batch_stats"]
                         for a in done):
        return None
    return 100.0 * sum(a["batch_stats"]["own_order_lanes"]
                       for a in done) / lanes
