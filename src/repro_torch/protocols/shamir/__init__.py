"""N-party Shamir secret sharing over GF(2^61 - 1) on PyTorch: the third
protocol family (after two-party garbled circuits and CKKS), exercising
the planner, the worker links and the overlap loop on round-structured
traces.  The port's copy of ``repro.protocols.shamir``."""

from .driver import SEED_INPUT, SEED_RESHARE, ShamirDriver
from .dsl import (ROUND_TAG, REVEAL_TAG, Shared, mul, reveal,
                  share_input)
from .field import (P, addmod, inverse, lagrange_at_zero, mulmod,
                    reconstruct, share, submod)

__all__ = [
    "P", "ROUND_TAG", "REVEAL_TAG", "SEED_INPUT", "SEED_RESHARE",
    "ShamirDriver", "Shared", "addmod", "inverse", "lagrange_at_zero",
    "mul", "mulmod", "reconstruct", "reveal", "share", "share_input",
    "submod",
]
