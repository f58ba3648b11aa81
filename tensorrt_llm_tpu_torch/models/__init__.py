from .modeling_utils import (DecoderModelForCausalLM, MODEL_REGISTRY,
                             ModelConfig, get_model_class, register_model)
from . import deepseek as _deepseek  # noqa: F401  (registers)
from . import gemma as _gemma  # noqa: F401
from . import glm as _glm  # noqa: F401
from . import glm4_moe as _glm4_moe  # noqa: F401
from . import gpt2 as _gpt2  # noqa: F401
from . import gpt_family as _gpt_family  # noqa: F401
from . import gpt_oss as _gpt_oss  # noqa: F401
from . import granite as _granite  # noqa: F401
from . import granite_moe as _granite_moe  # noqa: F401
from . import hunyuan as _hunyuan  # noqa: F401
from . import lfm2 as _lfm2  # noqa: F401
from . import llama as _llama  # noqa: F401
from . import llama_variants as _llama_variants  # noqa: F401
from . import mixtral as _mixtral  # noqa: F401
from . import olmo as _olmo  # noqa: F401
from . import phi as _phi  # noqa: F401
from . import qwen as _qwen  # noqa: F401
from . import qwen_moe as _qwen_moe  # noqa: F401
from .convert import from_jax_params

__all__ = ["DecoderModelForCausalLM", "MODEL_REGISTRY", "ModelConfig",
           "get_model_class", "register_model", "from_jax_params"]
