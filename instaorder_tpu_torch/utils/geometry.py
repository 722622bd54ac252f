"""Host-side (numpy) geometry helpers (counterpart of
instaorder_tpu/utils/geometry.py; only what the port's modules use)."""

from __future__ import annotations


def get_closest_int_multiple_of(n: int, m: int) -> int:
    """Round ``n`` to the nearest multiple of ``m`` (ties round up)."""
    r = n % m
    return n + (m - r) if r >= m // 2 else n - r
