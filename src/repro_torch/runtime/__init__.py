"""Runtime of the port: the losses (``losses``) and the step/request
monitors (``monitor``: :class:`~repro_torch.runtime.monitor.StepMonitor`,
:class:`~repro_torch.runtime.monitor.RequestLatency`).  The reference's
training loop is not ported yet."""
from . import losses, monitor

__all__ = ["losses", "monitor"]
