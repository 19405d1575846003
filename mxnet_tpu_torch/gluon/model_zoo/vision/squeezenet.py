"""SqueezeNet 1.0 and 1.1 — the port of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``, layer for layer, under
the reference's names."""

from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = _FireExpand(expand1x1_channels, expand3x3_channels)
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """Parallel 1x1 + 3x3 expand paths, concatenated on channels."""

    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.p1 = _make_fire_conv(e1, 1)
            self.p3 = _make_fire_conv(e3, 3, padding=1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise MXNetError(
                f"unsupported SqueezeNet version {version}: use 1.0 or 1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):  # noqa: ARG002
        x = self.features(x)
        return self.output(x)


def _squeeze(version, pretrained, **kwargs):
    if pretrained:
        raise MXNetError(
            "pretrained weights are not bundled (there is no model store); "
            "load a .params file via net.load_parameters() instead")
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(pretrained=False, ctx=None, **kwargs):  # noqa: ARG001
    return _squeeze("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, ctx=None, **kwargs):  # noqa: ARG001
    return _squeeze("1.1", pretrained, **kwargs)
