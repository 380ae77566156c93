"""Architecture registry: importing this package registers every config the
port runs (the dense qwen2-0.5b; the other families are ROADMAP queue 1
item 10)."""
from .base import ArchConfig, all_configs, get_config, reduced, register

from . import qwen2_0_5b  # noqa: F401  (registers)

__all__ = ["ArchConfig", "all_configs", "get_config", "reduced", "register"]
