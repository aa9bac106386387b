"""The LM architecture stack of the port (this slice: the dense family)."""
