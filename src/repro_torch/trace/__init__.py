"""repro_torch.trace: span-level execution tracing with pred-vs-measured
attribution and a persistent per-machine profile store.

The observability layer of the tool flow: a :class:`Tracer` threads
through ``pipeline.run_pipelined`` / ``run_stage_pipelined``,
``simulation.run_chain`` and ``flow.CompiledSystem.run()``; the recorded
spans/counters export to Chrome-trace JSON (:func:`write_chrome`, view
in Perfetto), fold against the plan's cost model
(:func:`attribution_report`), and feed the on-disk
:class:`ProfileStore` that ``explore_chain(profile=...)`` ranks with.

This package never imports ``repro_torch.memory`` at module level -- the
executors it instruments depend on staying import-light.
"""
from .attribution import (Attribution, StageAttribution, attribute,
                          attribution_report, chrome_counter_totals,
                          host_channel_bytes, samples_from_trace)
from .chrome import to_chrome, write_chrome
from .profile import (PROFILE_ENV, ProfileStore, default_profile_path,
                      machine_fingerprint)
from .schema import assert_valid, validate, validate_file
from .tracer import (HOST_TRACK, NULL, CounterEvent, NullTracer, SpanEvent,
                     TraceError, Tracer)

__all__ = [
    "Attribution",
    "CounterEvent",
    "HOST_TRACK",
    "NULL",
    "NullTracer",
    "PROFILE_ENV",
    "ProfileStore",
    "SpanEvent",
    "StageAttribution",
    "TraceError",
    "Tracer",
    "assert_valid",
    "attribute",
    "attribution_report",
    "chrome_counter_totals",
    "default_profile_path",
    "host_channel_bytes",
    "machine_fingerprint",
    "samples_from_trace",
    "to_chrome",
    "validate",
    "validate_file",
    "write_chrome",
]
