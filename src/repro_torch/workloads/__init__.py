from .base import (CKKS_PAGE_SHIFT, GC_PAGE_SHIFT, REGISTRY, Workload, get,
                   register)

__all__ = ["CKKS_PAGE_SHIFT", "GC_PAGE_SHIFT", "REGISTRY", "Workload", "get",
           "register"]
