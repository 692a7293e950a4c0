"""Checkpoints of the port: the reference's on-disk format, and the
elastic reshard of a stacked distributed state."""
