"""Process-local metrics registry: counters, gauges, histograms
(counterpart of ddp_practice_tpu/utils/metrics.py, copied: the port
imports nothing of the reference package).

`MetricsRegistry` creates or gets named metrics; `snapshot()` flattens
it to one dict and `render_text()` renders the Prometheus text
exposition (`labelled` names as `name{k="v"}`, histograms as summaries
with `_count`/`_sum`, and OpenMetrics `le` buckets with exemplars for a
histogram fed them), byte for byte the reference's. `labelled` caps the
distinct values a label takes (`set_label_limit`): past the cap a value
renders as "other" and `metrics_label_overflow_total` counts it.
Histogram quantiles are nearest-rank over a bounded reservoir;
`percentile_summary` is the one percentile the port quotes (the serve
bench's rows). The training driver counts `train_restarts_total` here
(train/elastic.py `run_with_restarts`); the serving plane's metrics are
ROADMAP A6.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

log = logging.getLogger(__name__)


def _escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _split_labelled(name: str):
    """Parse a `labelled()` registry key back into (base, [(k, v)...]).

    Inverse of `labelled` for the exposition renderer. Values are the
    raw strings labelled() embedded; a value containing "," or "=" is
    not representable in this key format (labelled's documented limit).
    """
    if not name.endswith("}") or "{" not in name:
        return name, []
    base, _, inner = name[:-1].partition("{")
    pairs = []
    for item in inner.split(","):
        k, _, v = item.partition("=")
        pairs.append((k, v))
    return base, pairs


def _render_labels(pairs) -> str:
    """`[(k, v)...]` -> `{k="v",...}` sorted by key, values escaped."""
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(pairs)
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ---------------------------------------------------- label cardinality guard
# A labelled() family's size is bounded by the number of DISTINCT label
# values it has ever seen; a label fed from unbounded input (request ids,
# error strings, hostnames) would grow the registry — and every scrape —
# without limit over a long run. The guard caps distinct values per
# (metric name, label key): the first `_LABEL_LIMIT` values pass through,
# everything after lands in the shared "other" bucket, counted in
# `metrics_label_overflow_total` (default registry) and warned once per
# family. Process-wide on purpose: labelled() is a pure key-maker used
# against many registries, and the blast radius of a high-cardinality
# label is the process, not one registry.
_LABEL_LIMIT = 64
_LABEL_OVERFLOW = "other"
_label_values: Dict[Tuple[str, str], set] = {}
_label_warned: set = set()
_label_lock = threading.Lock()


def set_label_limit(n: int) -> int:
    """Set the per-(metric, label) distinct-value cap; returns the old
    cap (so tests can restore it)."""
    global _LABEL_LIMIT
    if n < 1:
        raise ValueError("label limit must be positive")
    old, _LABEL_LIMIT = _LABEL_LIMIT, n
    return old


def reset_label_guard() -> None:
    """Forget seen label values (tests; a production process never does)."""
    with _label_lock:
        _label_values.clear()
        _label_warned.clear()


def labelled(name: str, **labels) -> str:
    """Render a labelled metric name: ``labelled("x", r="a")`` -> ``x{r=a}``.

    The registry keys metrics by flat string name; per-replica and
    per-reason families (router breaker state, sheds-by-reason) need one
    metric per label value. Labels render sorted, so the same label set
    always produces the same name however the caller spells the kwargs.
    Distinct values per (name, key) are capped (see the guard above):
    past the cap a value renders as "other" instead of minting a new
    registry entry.
    """
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        with _label_lock:
            seen = _label_values.setdefault((name, k), set())
            if v not in seen:
                if len(seen) >= _LABEL_LIMIT:
                    if (name, k) not in _label_warned:
                        _label_warned.add((name, k))
                        log.warning(
                            "metric %s label %s exceeded %d distinct values"
                            " — overflow bucketed to %r",
                            name, k, _LABEL_LIMIT, _LABEL_OVERFLOW,
                        )
                    v = _LABEL_OVERFLOW
                    overflow = True
                else:
                    seen.add(v)
                    overflow = False
            else:
                overflow = False
        if overflow:
            default_registry().counter(
                "metrics_label_overflow_total"
            ).inc()
        parts.append(f"{k}={v}")
    return f"{name}{{{','.join(parts)}}}"


class Counter:
    """Monotonic count (requests served, tokens emitted, sheds)."""

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up — use a Gauge")
        self.value += n


class Gauge:
    """Last-write-wins level (queue depth, slot occupancy)."""

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


# exemplar bucket bounds: latency-shaped (seconds), OpenMetrics-style
# cumulative `le` thresholds. An exemplar-fed histogram keeps the LAST
# trace_id observed per bucket, so an operator reading a bad p99 bucket
# in /metrics can jump straight to one offending trace in the merged
# timeline instead of grepping blind.
DEFAULT_EXEMPLAR_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, float("inf"),
)


class Histogram:
    """Streaming distribution with exact count/sum and reservoir quantiles.

    `observe(v, exemplar=...)` additionally files the observation into
    fixed `le` buckets and remembers the last exemplar (a trace_id) per
    bucket; `render_text` then emits OpenMetrics ``name_bucket{le=...}
    N # {trace_id="..."} v`` lines. Histograms never fed an exemplar
    render exactly as before (no bucket lines) — the exposition stays
    byte-stable for existing consumers.
    """

    def __init__(self, max_samples: int = 4096,
                 buckets: Sequence[float] = DEFAULT_EXEMPLAR_BUCKETS
                 ) -> None:
        if max_samples <= 0:
            raise ValueError("max_samples must be positive")
        self.count = 0
        self.sum = 0.0
        self._max = max_samples
        self._samples: list = []
        self._next = 0  # ring-buffer cursor once the reservoir is full
        self.buckets = tuple(buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("buckets must be ascending")
        self._bucket_counts = [0] * len(self.buckets)
        # bucket index -> (exemplar_id, value); None until an exemplar
        # was ever observed (gates the exposition's bucket section)
        self._exemplars: Optional[list] = None

    def _bucket_index(self, v: float) -> int:
        from bisect import bisect_left

        i = bisect_left(self.buckets, v)
        return min(i, len(self.buckets) - 1)

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        i = self._bucket_index(v)
        self._bucket_counts[i] += 1
        if exemplar is not None:
            if self._exemplars is None:
                self._exemplars = [None] * len(self.buckets)
            self._exemplars[i] = (str(exemplar), v)
        if len(self._samples) < self._max:
            self._samples.append(v)
        else:
            self._samples[self._next] = v
            self._next = (self._next + 1) % self._max

    def exemplar_for(self, p: float):
        """(exemplar_id, value) filed in the bucket holding the p-th
        percentile (None when that bucket never saw an exemplar) — the
        jump-from-p99-to-trace lookup /flight surfaces."""
        if self._exemplars is None or not self._samples:
            return None
        return self._exemplars[self._bucket_index(self.percentile(p))]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; nearest-rank over the retained reservoir."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        rank = min(len(s) - 1, max(0, round(p / 100.0 * (len(s) - 1))))
        return s[int(rank)]

    def summary(self, percentiles: Iterable[float] = (50, 90, 99)) -> dict:
        out = {"count": self.count, "mean": self.mean}
        for p in percentiles:
            out[f"p{p:g}"] = self.percentile(p)
        return out

    @classmethod
    def of(cls, values: Sequence[float]) -> "Histogram":
        """A histogram holding exactly `values` (offline summaries)."""
        h = cls(max_samples=max(len(values), 1))
        for v in values:
            h.observe(v)
        return h


def percentile_summary(values: Sequence[float],
                       percentiles: Iterable[float] = (50, 90, 99)) -> dict:
    """{"p50": ..., "p90": ..., "p99": ..., "mean": ...} over `values`.

    THE percentile implementation of the telemetry plane — the serve
    bench's latency rows, the /flight scrape endpoint, the SLO watchdog,
    and tools/check_slo.py all summarize through here (nearest-rank via
    Histogram.percentile), so a quantile quoted by any of them means the
    same thing. Empty input yields zeros, matching Histogram.
    """
    h = Histogram.of(values)
    out = {f"p{p:g}": h.percentile(p) for p in percentiles}
    out["mean"] = h.mean
    return out


class MetricsRegistry:
    """Create-or-get named metrics; snapshot() flattens to one dict.

    Thread-safe on the create path only (a serve loop is single-threaded,
    but request submission may come from another thread); individual
    updates are plain float ops under the GIL.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(
                name, Histogram(max_samples=max_samples)
            )

    def snapshot(self) -> dict:
        """Flat `{name: value}` dict; histograms expand to name_count /
        name_mean / name_p50 / name_p90 / name_p99. The metric dicts
        are copied under the create-lock first — a background reader
        (the telemetry exporter's snapshot thread, an HTTP scrape) must
        not race a serve loop that is still minting labelled metrics."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        out: dict = {}
        for name, c in counters.items():
            out[name] = c.value
        for name, g in gauges.items():
            out[name] = g.value
        for name, h in histograms.items():
            for k, v in h.summary().items():
                out[f"{name}_{k}"] = v
        return out

    def render_text(self) -> str:
        """Prometheus text exposition of the registry.

        `labelled()` names render as ``name{k="v"}`` (labels sorted by
        key, values escaped per the exposition format: backslash, quote,
        newline); histograms render as summaries — ``name{quantile=
        "0.5"}`` / ``"0.9"`` / ``"0.99"`` over the reservoir plus exact
        ``name_count`` and ``name_sum``. One ``# TYPE`` line per metric
        family, families sorted by name — the output is byte-stable for
        a given registry state, so a scrape endpoint or a test can diff
        it. Ends with a trailing newline per the format spec.
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        lines = []

        def simple(metrics, kind):
            fams: Dict[str, list] = {}
            for name, m in metrics.items():
                base, pairs = _split_labelled(name)
                fams.setdefault(base, []).append((pairs, m.value))
            for base in sorted(fams):
                lines.append(f"# TYPE {base} {kind}")
                for pairs, value in sorted(
                        fams[base], key=lambda pv: _render_labels(pv[0])):
                    lines.append(
                        f"{base}{_render_labels(pairs)} {_fmt_value(value)}"
                    )

        simple(counters, "counter")
        simple(gauges, "gauge")
        for name in sorted(histograms):
            h = histograms[name]
            base, pairs = _split_labelled(name)
            lines.append(f"# TYPE {base} summary")
            for q, p in (("0.5", 50), ("0.9", 90), ("0.99", 99)):
                qpairs = pairs + [("quantile", q)]
                lines.append(
                    f"{base}{_render_labels(qpairs)} "
                    f"{_fmt_value(h.percentile(p))}"
                )
            lines.append(
                f"{base}_count{_render_labels(pairs)} {_fmt_value(h.count)}"
            )
            lines.append(
                f"{base}_sum{_render_labels(pairs)} {_fmt_value(h.sum)}"
            )
            if h._exemplars is not None:
                # OpenMetrics exemplar section — only for histograms
                # actually FED exemplars (trace_ids from completions),
                # so the classic summary output above stays byte-stable
                # for everything else. Cumulative le buckets; the last
                # exemplar filed in a bucket rides its line as
                # `# {trace_id="..."} value`.
                cum = 0
                for i, le in enumerate(h.buckets):
                    cum += h._bucket_counts[i]
                    le_s = "+Inf" if le == float("inf") else _fmt_value(le)
                    bpairs = pairs + [("le", le_s)]
                    line = (f"{base}_bucket{_render_labels(bpairs)} "
                            f"{_fmt_value(cum)}")
                    ex = h._exemplars[i]
                    if ex is not None:
                        eid, ev = ex
                        line += (f' # {{trace_id="'
                                 f'{_escape_label_value(eid)}"}} '
                                 f"{_fmt_value(ev)}")
                    lines.append(line)
        return "\n".join(lines) + "\n"


_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """Process-wide registry for callers that don't thread their own."""
    global _default
    if _default is None:
        _default = MetricsRegistry()
    return _default
