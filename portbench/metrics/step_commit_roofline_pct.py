"""``step_commit``'s share of its roofline: the bytes a launch must move
(:func:`portbench.roofline.commit_bytes`, bound by bytes) at the H100's
HBM bandwidth, over the launch's device time, in percent.

Bytes are the window's mean over its launches by ``(P, S, B)``
(``lockstep_step.SHAPES``, credited at every replay), counting no lane as
live (the live count inside a replayed graph is the device's and is not
read back): a floor on the bytes.  Time is the traced slice's mean
``step_commit`` device time from the profiler's rows."""

from portbench.roofline import HBM_BYTES_PER_S, commit_bytes


def read(run):
    dt = run["devtrace"]
    shapes = run["counters"]["shapes"]
    if dt is None or not shapes:
        return None
    rows = [v for k, v in dt["ops"].items() if "step_commit" in k]
    n_slice = sum(r[0] for r in rows)
    t_slice = sum(r[1] for r in rows)
    if n_slice == 0 or t_slice <= 0:
        return None
    n = sum(shapes.values())
    mean_bytes = sum(commit_bytes(S, B, 0) * c
                     for (_, S, B), c in shapes.items()) / n
    return 100.0 * (mean_bytes / HBM_BYTES_PER_S) / (t_slice / n_slice)
