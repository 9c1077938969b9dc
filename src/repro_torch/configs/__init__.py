"""Architecture configs the port serves (one module per arch)."""
from .registry import ARCH_NAMES, PORTED, get, reduced  # noqa: F401
