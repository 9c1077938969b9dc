"""Serving substrate of the port: slot-based continuous batching engine."""
from .engine import Request, ServeConfig, ServingEngine  # noqa: F401
