from .base import GC_PAGE_SHIFT, REGISTRY, Workload, get, register

__all__ = ["GC_PAGE_SHIFT", "REGISTRY", "Workload", "get", "register"]
