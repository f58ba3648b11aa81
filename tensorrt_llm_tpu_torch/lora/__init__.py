from .lora_manager import LoraConfig, LoraManager, LoraRequest  # noqa: F401
