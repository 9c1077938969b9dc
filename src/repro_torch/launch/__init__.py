"""Launchers of the port: serving, the streaming service and training."""
