"""Model zoo of the port: the Gluon BERT (``bert``), the vision zoo
(``vision``), the llama family (``llama``), YOLOv3 (``yolo``) and the
transformer-base MT model (``transformer``), all Gluon blocks named as the
reference names them."""

from . import vision  # noqa: F401


def __getattr__(name):
    import importlib
    if name in ("bert", "llama", "transformer", "yolo"):
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_model(name, **kwargs):
    """A vision model by the reference's name (``model_zoo.get_model``)."""
    return vision.get_model(name, **kwargs)
