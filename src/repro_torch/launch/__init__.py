"""Launchers of the port."""
