"""Architecture configurations (data only; counterpart of
``repro.configs``)."""
from .base import ArchConfig, get_arch, list_archs, register  # noqa: F401
