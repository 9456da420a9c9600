"""Configuration of the port (the JAX package's ``configs``): the YAML
config tree with dotted overrides, and the name registry."""

from .config import Config, apply_overrides, copy_config, load_config
from .registry import Registry

__all__ = ["Config", "Registry", "apply_overrides", "copy_config",
           "load_config"]
