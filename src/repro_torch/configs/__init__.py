"""Architecture configs the port serves (one module per arch) + shapes."""
from .registry import (ARCH_NAMES, PORT_ONLY, PORTED, ArchInfo, get, info,  # noqa: F401
                       reduced)
from .shapes import SHAPES, Shape, batch_specs, input_specs  # noqa: F401
