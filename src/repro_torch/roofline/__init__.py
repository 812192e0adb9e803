# The three-term roofline of the JAX package's ``repro/roofline`` with the
# card's hardware record (``H100``).  ``analyze_record``/``analyze_all``
# and ``load_artifacts`` wait for the port's dry-run (ROADMAP 1.7).
from .model import (H100, HW, CellRoofline, extrapolate_terms, model_flops,
                    roofline_table)

__all__ = ["H100", "HW", "CellRoofline", "extrapolate_terms", "model_flops",
           "roofline_table"]
