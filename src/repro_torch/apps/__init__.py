# The paper's evaluated applications, written against the @task API the way
# Fig. 1 / Fig. 4 write them against OmpSs pragmas.
from . import cholesky, matmul

__all__ = ["matmul", "cholesky"]
