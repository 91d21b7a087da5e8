"""CKKS on PyTorch: parameters, the negacyclic NTT through the card's
kernels, the twisted-FFT encoding, RNS cipher operations, the driver and
the Batch DSL.  The names the JAX package's ``repro.protocols.ckks``
exports resolve on first use (PEP 562): ``kernels.ntt`` imports
``params``, and ``cipher`` imports ``kernels.ntt``, so this package
imports nothing when it loads."""

__all__ = ["Batch", "CkksContext", "CkksCostModel", "CkksDriver",
           "CkksParams", "Plain"]


def __getattr__(name: str):
    if name == "CkksParams":
        from . import params as mod
    elif name == "CkksContext":
        from . import cipher as mod
    elif name in __all__:
        from . import driver as mod
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(mod, name)
