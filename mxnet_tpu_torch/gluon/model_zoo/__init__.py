"""Model zoo of the port: the Gluon BERT (``bert``), the vision zoo's
ResNets (``vision``) and the llama family (``llama``, ``torch.nn`` modules
so far)."""

from . import vision  # noqa: F401


def get_model(name, **kwargs):
    """A vision model by the reference's name (``model_zoo.get_model``)."""
    return vision.get_model(name, **kwargs)
