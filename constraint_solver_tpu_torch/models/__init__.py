"""Problem domains.  Ported so far: N-Queens."""
