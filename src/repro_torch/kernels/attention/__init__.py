from . import attention, ops, ref
from .attention import flash_attention
from .ref import flash_attention_plain

__all__ = ["attention", "ops", "ref", "flash_attention", "flash_attention_plain"]
