"""Percentile summaries (counterpart of ddp_practice_tpu/utils/metrics.py
`percentile_summary`): nearest-rank quantiles, so a quantile the port
quotes means what the reference's bench rows mean."""

from __future__ import annotations

from typing import Iterable, Sequence


def percentile_summary(values: Sequence[float],
                       percentiles: Iterable[float] = (50, 90, 99)) -> dict:
    """{"p50": ..., "p90": ..., "p99": ..., "mean": ...} over `values`;
    empty input yields zeros."""
    s = sorted(float(v) for v in values)
    out = {}
    for p in percentiles:
        if not s:
            out[f"p{p:g}"] = 0.0
            continue
        rank = min(len(s) - 1, max(0, round(p / 100.0 * (len(s) - 1))))
        out[f"p{p:g}"] = s[int(rank)]
    out["mean"] = sum(s) / len(s) if s else 0.0
    return out
