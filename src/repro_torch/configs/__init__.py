"""Architecture configs the port serves (one module per arch) + shapes."""
from .registry import ARCH_NAMES, PORTED, ArchInfo, get, info, reduced  # noqa: F401
from .shapes import SHAPES, Shape, batch_specs, input_specs  # noqa: F401
