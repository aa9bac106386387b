"""Numpy data layer of the port: synthetic M4 series, splits, batch schedule."""
