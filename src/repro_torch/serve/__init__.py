# The sweep service's wire protocol.  The service itself (sweepd and its
# cross-request coalescer) is not ported yet.
__all__ = ["protocol"]
