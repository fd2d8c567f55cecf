from .config import ModelConfig, SubLayer
from .convert import params_from_jax
from .transformer import Transformer

__all__ = ["ModelConfig", "SubLayer", "Transformer", "params_from_jax"]
