"""Paged KV-cache subsystem: host-side page-table/refcount/prefix-cache
bookkeeping for the global device page pools (docs/kv_paging.md)."""
from .allocator import AdmitPlan, PagedAllocator, PoolExhausted

__all__ = ["AdmitPlan", "PagedAllocator", "PoolExhausted"]
