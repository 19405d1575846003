"""Gluon-level models of the port (``gluon.model_zoo``)."""
