"""Always-on serving telemetry: registry, SLOs, exposition, invariants.

The live complement to ``repro_torch.trace``'s bounded after-the-fact traces:

  * :class:`MetricsRegistry` hands out :class:`Counter` /
    :class:`Gauge` / :class:`Histogram` series by (name, labels)
    identity; :data:`NULL_REGISTRY` is the falsy no-op twin (the
    ``trace.NULL`` pattern), so unmetered hot paths cost one truthiness
    check.
  * :class:`SLOTracker` turns a p95 latency target and an error budget
    into windowed burn rates and an ``ok``/``warn``/``breach`` verdict.
  * :func:`export_prometheus` / :func:`write_snapshot` expose the
    registry as Prometheus text or snapshot JSON;
    :func:`check_snapshot` enforces the serving conservation laws and
    reconciles against the trace counters (``python -m repro_torch.metrics``).

Wired through ``repro_torch.serve`` (engine/queue/cache ``metrics=``,
``--metrics out.json`` on the serve and flow CLIs) and duck-typed into
``memory.pipeline.StagePipelineDriver`` exactly like the tracer.
"""
from .check import (check_snapshot, check_structure, diff_snapshots,
                    trace_counter_totals)
from .expo import export_prometheus, write_snapshot
from .registry import (DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram,
                       MetricsError, MetricsRegistry, NULL_REGISTRY,
                       NullRegistry, linear_buckets, log_buckets)
from .slo import SLOTracker, VERDICTS

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsError", "MetricsRegistry",
    "NullRegistry", "NULL_REGISTRY", "DEFAULT_TIME_BUCKETS",
    "log_buckets", "linear_buckets", "SLOTracker", "VERDICTS",
    "export_prometheus", "write_snapshot", "check_snapshot",
    "check_structure", "diff_snapshots", "trace_counter_totals",
]
