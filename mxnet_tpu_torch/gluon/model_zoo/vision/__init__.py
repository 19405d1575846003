"""gluon.model_zoo.vision — the port of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``.

``get_model(name, classes=..., ...)`` resolves the reference's model-name
strings.  The ResNets (v1 and v2, 18-152 layers) are ported; the other
names of the reference's table raise ``MXNetError("... not yet
ported")``, and ``pretrained=True`` raises as in the reference (no model
store: load a ``.params`` file with ``net.load_parameters``).
"""

from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1,
    "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1,
    "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}

# the rest of the reference's table (vgg.py, alexnet.py, densenet.py,
# squeezenet.py, inception.py, mobilenet.py)
_NOT_PORTED = (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "densenet121", "densenet161", "densenet169",
    "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """Build a model by the reference's name string."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"model {name!r} is not yet ported to "
                         f"mxnet_tpu_torch; ported: {sorted(_models)}")
    if name not in _models:
        raise MXNetError(
            f"model {name!r} is not in the model zoo; "
            f"options: {sorted([*_models, *_NOT_PORTED])}")
    return _models[name](**kwargs)
