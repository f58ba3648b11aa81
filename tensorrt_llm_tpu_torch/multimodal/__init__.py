"""Multimodal: the vision encoders, the input processors and the
splice-only vision-language models (the JAX package's ``multimodal``:
llava, llava_next, mistral3 / Pixtral and internvl; the M-RoPE,
image-group and cross-attention families are not ported yet and are
refused by name, models/modeling_utils.NOT_PORTED_MODEL_TYPES)."""
from .encoders import VisionTower
from .processor import (INPUT_PROCESSOR_REGISTRY, create_input_processor,
                        mm_hash, register_input_processor)
from . import llava as _llava  # noqa: F401  (registers model + processor)
from . import llava_next as _llava_next  # noqa: F401
from . import pixtral as _pixtral  # noqa: F401
from . import internvl as _internvl  # noqa: F401

__all__ = ["VisionTower", "create_input_processor", "mm_hash",
           "register_input_processor", "INPUT_PROCESSOR_REGISTRY"]
