"""Crash checkpoints of the port: the reference store's on-disk format."""
from .store import CheckpointError, CheckpointStore  # noqa: F401
