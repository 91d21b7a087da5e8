"""CKKS on PyTorch: parameters, the negacyclic NTT through the card's
kernels, the twisted-FFT encoding, RNS cipher operations, the driver and
the Batch DSL.  (No imports here: ``kernels.ntt`` imports ``params``, and
``cipher`` imports ``kernels.ntt``.)"""
