"""Data sources and the host-to-device prefetch, as the reference's
``repro.data``."""
from .pipeline import PrefetchPipeline
from .synthetic import TokenStream, cfd_element_stream

__all__ = ["PrefetchPipeline", "TokenStream", "cfd_element_stream"]
