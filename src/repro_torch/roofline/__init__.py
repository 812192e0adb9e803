# The three-term roofline of the JAX package's ``repro/roofline`` with the
# card's hardware record (``H100``): the model over the port's dry-run
# records (``analyze_record``/``analyze_all`` over ``load_artifacts``) and
# the analytic HBM-traffic floor (``analytic``).
from .model import (H100, HW, CellRoofline, analyze_all, analyze_record,
                    extrapolate_terms, load_artifacts, model_flops,
                    roofline_table)

__all__ = ["H100", "HW", "CellRoofline", "analyze_all", "analyze_record",
           "extrapolate_terms", "load_artifacts", "model_flops",
           "roofline_table"]
