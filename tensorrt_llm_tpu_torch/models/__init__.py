from .modeling_utils import (DecoderModelForCausalLM, MODEL_REGISTRY,
                             ModelConfig, get_model_class, register_model)
from . import bamba as _bamba  # noqa: F401  (registers)
from . import bert as _bert  # noqa: F401
from . import deepseek as _deepseek  # noqa: F401
from . import gemma as _gemma  # noqa: F401
from . import glm as _glm  # noqa: F401
from . import glm4_moe as _glm4_moe  # noqa: F401
from . import gpt2 as _gpt2  # noqa: F401
from . import gpt_family as _gpt_family  # noqa: F401
from . import gpt_oss as _gpt_oss  # noqa: F401
from . import granite as _granite  # noqa: F401
from . import granite_hybrid as _granite_hybrid  # noqa: F401
from . import granite_moe as _granite_moe  # noqa: F401
from . import hunyuan as _hunyuan  # noqa: F401
from . import jamba as _jamba  # noqa: F401
from . import lfm2 as _lfm2  # noqa: F401
from . import llama as _llama  # noqa: F401
from . import llama_variants as _llama_variants  # noqa: F401
from . import mamba as _mamba  # noqa: F401
from . import mamba2 as _mamba2  # noqa: F401
from . import minimax as _minimax  # noqa: F401
from . import mixtral as _mixtral  # noqa: F401
from . import olmo as _olmo  # noqa: F401
from . import phi as _phi  # noqa: F401
from . import qwen as _qwen  # noqa: F401
from . import qwen3_next as _qwen3_next  # noqa: F401
from . import qwen_moe as _qwen_moe  # noqa: F401
from . import zamba2 as _zamba2  # noqa: F401
from .convert import from_jax_params
from ..multimodal import internvl as _internvl  # noqa: F401,E402
from ..multimodal import llava as _llava  # noqa: F401,E402
from ..multimodal import llava_next as _llava_next  # noqa: F401,E402
from ..multimodal import pixtral as _pixtral  # noqa: F401,E402

__all__ = ["DecoderModelForCausalLM", "MODEL_REGISTRY", "ModelConfig",
           "get_model_class", "register_model", "from_jax_params"]
