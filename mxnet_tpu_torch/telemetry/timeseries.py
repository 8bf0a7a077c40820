"""Quantile helper shared by the serve stats reservoirs."""

from __future__ import annotations

__all__ = ["nearest_rank"]


def nearest_rank(sorted_vals, q):
    """Nearest-rank quantile of an ascending list (None when empty) —
    the quantile convention of the whole observability stack, so
    percentiles agree with the reference's on the same data."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]
