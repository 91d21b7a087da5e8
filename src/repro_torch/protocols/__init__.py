"""Protocol drivers of the port: ``garbled`` (two-party half gates)."""
