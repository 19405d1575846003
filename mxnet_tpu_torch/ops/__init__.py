"""Operators of the port (the attention core of ``ops.contrib`` so far)."""
