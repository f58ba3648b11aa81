from .modeling_utils import (DecoderModelForCausalLM, MODEL_REGISTRY,
                             ModelConfig, get_model_class, register_model)
from . import llama as _llama  # noqa: F401  (registers)
from .convert import from_jax_params

__all__ = ["DecoderModelForCausalLM", "MODEL_REGISTRY", "ModelConfig",
           "get_model_class", "register_model", "from_jax_params"]
