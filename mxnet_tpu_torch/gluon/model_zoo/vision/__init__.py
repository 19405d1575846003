"""gluon.model_zoo.vision — the port of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``.

``get_model(name, classes=..., ...)`` resolves every model-name string of
the reference's table: the ResNets (v1 and v2, 18-152 layers), VGG (with
and without batch norm), AlexNet, DenseNet, SqueezeNet, Inception V3 and
MobileNet v1 and v2.  ``pretrained=True`` raises as in the reference (no
model store: load a ``.params`` file with ``net.load_parameters``).
"""

from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

from ....base import MXNetError

# the star imports bind the constructors (the function ``alexnet`` shadows
# its module's name, as in the reference)
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
    "vgg11": vgg11,
    "vgg13": vgg13,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "vgg11_bn": vgg11_bn,
    "vgg13_bn": vgg13_bn,
    "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121,
    "densenet161": densenet161,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0,
    "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0,
    "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5,
    "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """Build a model by the reference's name string."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"model {name!r} is not in the model zoo; "
            f"options: {sorted(_models)}")
    return _models[name](**kwargs)
