"""Runtime of the port: the losses (``losses``), the step/request
monitors (``monitor``: :class:`~repro_torch.runtime.monitor.StepMonitor`,
:class:`~repro_torch.runtime.monitor.RequestLatency`) and the train-step
builders and fault-tolerant loop (``train``)."""
from . import losses, monitor, train

__all__ = ["losses", "monitor", "train"]
