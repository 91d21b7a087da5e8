from .base import (CKKS_PAGE_SHIFT, GC_PAGE_SHIFT, REGISTRY, Workload,
                   all_names, get, register)

__all__ = ["CKKS_PAGE_SHIFT", "GC_PAGE_SHIFT", "REGISTRY", "Workload",
           "all_names", "get", "register"]
