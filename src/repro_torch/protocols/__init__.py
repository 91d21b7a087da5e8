"""Protocol drivers of the port: ``garbled`` (two-party half gates),
``ckks`` (RNS CKKS) and ``shamir`` (n-party Shamir sharing)."""
