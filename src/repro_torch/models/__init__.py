"""Model zoo of the port: the decoder families ``dense``, ``moe`` and
``vlm`` (``transformer``, with the MoE FFN in ``moe``), the
encoder-decoder (whisper, ``transformer``), the jamba hybrid
(``hybrid``, with its Mamba mixer in ``ssm``) and the xLSTM
(``transformer``, with its recurrent blocks in ``ssm``), their
``layers``, the ``api`` facade, and ``convert`` for params made by the
reference."""
from . import api, config, convert, hybrid, layers, moe, ssm, transformer
from .api import Model, build_model
from .config import MambaConfig, ModelConfig, MoEConfig, XLSTMConfig
from .convert import params_from_jax, train_state_from_jax

__all__ = [
    "api", "config", "convert", "hybrid", "layers", "moe", "ssm",
    "transformer", "Model", "build_model", "params_from_jax",
    "train_state_from_jax", "MambaConfig", "ModelConfig", "MoEConfig",
    "XLSTMConfig",
]
