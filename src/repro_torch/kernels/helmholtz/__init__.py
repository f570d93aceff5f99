from . import helmholtz, ops
from .helmholtz import inverse_helmholtz, inverse_helmholtz_plain

__all__ = ["helmholtz", "ops", "inverse_helmholtz", "inverse_helmholtz_plain"]
