"""Model zoo of the port: the dense, SSM and hybrid families."""
from .config import ModelConfig  # noqa: F401
from .model import Model  # noqa: F401
from .params import init_params  # noqa: F401
