# The LM serving engine (engine: prefill and decode steps, greedy batched
# Engine) and the sweep service's wire protocol.  The service itself
# (sweepd and its cross-request coalescer) is not ported yet.
__all__ = ["engine", "protocol"]
