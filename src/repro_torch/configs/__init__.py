"""Architecture configs the port serves (one module per arch)."""
from .registry import ARCH_NAMES, PORTED, ArchInfo, get, info, reduced  # noqa: F401
