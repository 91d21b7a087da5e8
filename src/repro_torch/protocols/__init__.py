"""Protocol drivers of the port: ``garbled`` (two-party half gates) and
``ckks`` (RNS CKKS)."""
