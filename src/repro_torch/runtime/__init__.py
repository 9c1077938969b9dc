"""Runtime health: heartbeats, stragglers, elastic pool."""
from .monitor import HealthConfig, HealthMonitor  # noqa: F401
