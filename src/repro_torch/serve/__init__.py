"""repro_torch.serve -- the long-running service around a compiled system.

Three layers, one per module:

  * :mod:`repro_torch.serve.cache` -- :class:`PlanCache`: compile calls keyed
    by ``(post-rewrite program sha, target, policy, topology, knobs)``;
    repeat compiles return the cached
    :class:`~repro_torch.flow.build.CompiledSystem` (DSE winner included)
    without re-planning.
  * :mod:`repro_torch.serve.queue` -- :class:`AdmissionQueue`: FIFO
    coalescing of :class:`ServeRequest` element rows into planner-sized
    ``E``-element waves, padded (and pad-accounted) when the
    max-latency knob flushes an undersized wave.
  * :mod:`repro_torch.serve.engine` -- :class:`ServeEngine`: waves feed the
    plan's stage-pipelined dispatch ring with a bounded in-flight
    window; :class:`Backpressure` / :class:`DrainTimeout` /
    :class:`EngineShutdown` give submit/drain/shutdown defined
    semantics instead of wedging the ring.

``python -m repro_torch.serve prog.cfd --requests 32 --smoke`` runs the
whole stack against per-request serial execution (bitwise equality).
"""
from .cache import PlanCache
from .cli import main
from .engine import (Backpressure, DrainTimeout, EngineShutdown,
                     ServeEngine)
from .queue import AdmissionQueue, ServeRequest, Wave, WavePart

__all__ = [
    "AdmissionQueue",
    "Backpressure",
    "DrainTimeout",
    "EngineShutdown",
    "PlanCache",
    "ServeEngine",
    "ServeRequest",
    "Wave",
    "WavePart",
    "main",
]
