"""Serving substrate of the port: slot-based continuous batching engine."""
from .engine import Request, ServeConfig, ServingEngine  # noqa: F401
from .adapter import ServingArrivals, request_job_spec  # noqa: F401
