"""The share of the window's candidates that the explorer's
branch-and-bound proved outside the top k without ranking them: the
names the answered top-k sweeps reported ``pruned`` (statically or
retired mid-sweep) over their candidates, in percent.  None where no
answered sweep pruned by request."""


def read(run):
    done = [a for a in run["answers"] if a["ok"] and "pruned" in a]
    lanes = sum(len(a["expected"]) for a in done)
    if lanes == 0:
        return None
    return 100.0 * sum(len(a["pruned"]) for a in done) / lanes
