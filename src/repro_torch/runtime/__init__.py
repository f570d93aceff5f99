"""Runtime of the port: the losses (``losses``).  The training and
serving loops of the reference are not ported yet."""
from . import losses

__all__ = ["losses"]
