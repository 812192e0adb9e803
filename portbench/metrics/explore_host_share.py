"""The share of the sweeps' time spent outside the torch engine's step
loop: the explorer and replay protocol's host work (graphs, order
discovery, reference lanes, assembly, ranked schedules).  Sweep seconds
are the ``Explorer.explore`` spans, step-loop seconds the
``torchsim._scan_cohorts`` spans (:mod:`portbench.spans`); in percent."""


def read(run):
    spans = run["spans"]
    if spans is None:
        return None
    sweep = spans.seconds("explore")
    if sweep <= 0:
        return None
    return 100.0 * (sweep - spans.seconds("step_loop")) / sweep
