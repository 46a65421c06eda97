"""Launchers of the port: the CNNSelect serving CLI."""
