"""gluon.nn convolution and pooling layers — the port of
``mxnet_tpu/gluon/nn/conv_layers.py``: Conv1D/2D/3D, Conv1D/2D/3DTranspose,
Max/Avg/GlobalMax/GlobalAvg pooling in 1-3 dims and ReflectionPad2D, over
the ``Convolution``, ``Deconvolution``, ``Pooling`` and ``pad`` ops
(``torch.nn.functional``: cuDNN on the card).  Layout NC(D)HW only, as in
the reference; weights (out_c, in_c/groups, *kernel), or (in_c,
out_c/groups, *kernel) for a transpose, deferred while ``in_channels`` is
0."""

from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuplize(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            n = len(kernel_size)
            self._kwargs = {
                "kernel": kernel_size,
                "stride": strides,
                "dilate": dilation,
                "pad": padding,
                "num_filter": channels,
                "num_group": groups,
                "no_bias": not use_bias,
            }
            if adj is not None:
                self._kwargs["adj"] = adj
            self._op_name = op_name
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + kernel_size
            else:  # Deconvolution weight is (in_c, out_c/groups, *k)
                wshape = (in_channels, channels // groups) + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None
            if self.act is not None:
                self.register_child(self.act, "act")

    def infer_param_shapes(self, args):
        in_c = args[0].shape[1]
        g = self._kwargs["num_group"]
        k = self._kwargs["kernel"]
        if self._op_name == "Convolution":
            self.weight.shape_mismatch_update((self._channels, in_c // g) + k)
        else:
            self.weight.shape_mismatch_update((in_c, self._channels // g) + k)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1),
                         _tuplize(strides, 1),
                         _tuplize(padding, 1), _tuplize(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2),
                         _tuplize(strides, 2),
                         _tuplize(padding, 2), _tuplize(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3),
                         _tuplize(strides, 3),
                         _tuplize(padding, 3), _tuplize(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1),
                         _tuplize(strides, 1),
                         _tuplize(padding, 1), _tuplize(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuplize(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2),
                         _tuplize(strides, 2),
                         _tuplize(padding, 2), _tuplize(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuplize(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3),
                         _tuplize(strides, 3),
                         _tuplize(padding, 3), _tuplize(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuplize(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size,
            "stride": strides,
            "pad": padding,
            "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 1),
                         _tuplize(strides, 1) if strides is not None else None,
                         _tuplize(padding, 1), ceil_mode, False, "max",
                         layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 2),
                         _tuplize(strides, 2) if strides is not None else None,
                         _tuplize(padding, 2), ceil_mode, False, "max",
                         layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 3),
                         _tuplize(strides, 3) if strides is not None else None,
                         _tuplize(padding, 3), ceil_mode, False, "max",
                         layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuplize(pool_size, 1),
                         _tuplize(strides, 1) if strides is not None else None,
                         _tuplize(padding, 1), ceil_mode, False, "avg",
                         layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 2),
                         _tuplize(strides, 2) if strides is not None else None,
                         _tuplize(padding, 2), ceil_mode, False, "avg",
                         layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 3),
                         _tuplize(strides, 3) if strides is not None else None,
                         _tuplize(padding, 3), ceil_mode, False, "avg",
                         layout, count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), False, True, "max", layout,
                         **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "max", layout,
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "max",
                         layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), False, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "avg",
                         layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
