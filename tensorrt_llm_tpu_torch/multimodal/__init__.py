"""Multimodal: the vision encoders, the input processors, the splice-only
vision-language models (the JAX package's ``multimodal``: llava,
llava_next, mistral3 / Pixtral and internvl), the M-RoPE ones (qwen2_vl,
qwen2_5_vl, qwen3_vl, qwen3_vl_moe, glm4v), the image-group ones (gemma3 /
gemma3_vl, paligemma) and the cross-attention one (mllama): every
multimodal type the JAX package registers."""
from .encoders import VisionTower
from .processor import (INPUT_PROCESSOR_REGISTRY, create_input_processor,
                        mm_hash, register_input_processor)
from . import llava as _llava  # noqa: F401  (registers model + processor)
from . import llava_next as _llava_next  # noqa: F401
from . import pixtral as _pixtral  # noqa: F401
from . import internvl as _internvl  # noqa: F401
from . import qwen2_vl as _qwen2_vl  # noqa: F401
from . import qwen3_vl as _qwen3_vl  # noqa: F401
from . import glm4v as _glm4v  # noqa: F401
from . import gemma3_vl as _gemma3_vl  # noqa: F401
from . import paligemma as _paligemma  # noqa: F401
from . import mllama as _mllama  # noqa: F401

__all__ = ["VisionTower", "create_input_processor", "mm_hash",
           "register_input_processor", "INPUT_PROCESSOR_REGISTRY"]
