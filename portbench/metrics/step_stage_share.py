"""The share of the step loop's seconds spent staging its inputs: the
port's ``step.stage`` spans (each cohort's step inputs, the megabatch
stack, the lane-aligned packing and its copy to the device, each slice's
initial clocks) over its ``step_loop`` spans (``torchsim._scan_cohorts``),
in percent (:mod:`portbench.program_spans`)."""

from portbench.program_spans import share


def read(run):
    return share(run, "step.stage", "step_loop")
