"""Dry-run analysis: the roofline of a cell (:mod:`.roofline`), the
loop composition (:mod:`.scancost`) and the tables (:mod:`.aggregate`)."""
from . import roofline

__all__ = ["roofline"]
