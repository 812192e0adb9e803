"""The device's idle share over the measured window of a ``--trace 1``
run: one less the device's seconds inside ``StepRunner.run`` calls (two
CUDA events around each, :meth:`portbench.spans.Spans.device_seconds`)
over the window's wall (its start to the end of its last sweep), in
percent.  The window runs without the profiler.  Kernels outside the
step loop (the host's own path launches none) count as idle."""


def read(run):
    spans = run["spans"]
    if spans is None or not run["answers"]:
        return None
    busy = spans.device_seconds()
    wall = max(a["t1"] for a in run["answers"])
    if busy is None or wall <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
