# Serving substrate: the LM prefill/decode engine plus the sweep service
# (sweepd, its wire protocol and its cross-request coalescer).
#
# Submodules load lazily (PEP 562): the sweep-service modules stay free of
# the LM engine's imports, and a server decides its pool start method
# before any torch-engine request runs.
import importlib

__all__ = ["engine", "protocol", "coalesce", "sweepd"]


def __getattr__(name):
    if name in __all__:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
