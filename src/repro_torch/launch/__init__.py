"""Launchers of the port: the serving driver."""
