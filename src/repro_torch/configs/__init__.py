"""Assigned-architecture configs (one module per arch) + registry."""
from .registry import ARCH_IDS, CLI_TO_MODULE, all_configs, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "CLI_TO_MODULE", "all_configs", "get_config",
           "get_smoke_config"]
