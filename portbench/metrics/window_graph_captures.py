"""CUDA graphs captured inside the window by the process-wide compile
cache (``CompileCache.as_dict()["captures"]``, ``core/graphcache.py``):
0 when set-up warmed every shape signature the window uses."""


def read(run):
    return float(run["counters"]["cache"]["captures"])
