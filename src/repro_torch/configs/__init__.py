from .base import ARCH_IDS, ArchConfig, get_config  # noqa: F401
