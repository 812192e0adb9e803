"""The torch engine's step rate: step-commit launches in the window (one
a step, ``lockstep_step.LAUNCHES``, credited at every graph replay) over
the step loop's seconds (the ``torchsim._scan_cohorts`` spans)."""


def read(run):
    spans = run["spans"]
    if spans is None:
        return None
    loop = spans.seconds("step_loop")
    steps = run["counters"]["launches"]
    if loop <= 0 or steps <= 0:
        return None
    return steps / loop
