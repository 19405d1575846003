"""Operators of the port, registered under the reference's names
(``ops/registry.py``); importing the package registers them all."""

from . import registry  # noqa: F401
from . import elemwise, reduce, matrix, nn, contrib, optimizer_ops  # noqa: F401
