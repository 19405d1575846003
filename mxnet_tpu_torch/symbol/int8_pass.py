"""The ``INT8`` graph pass of ``Symbol.optimize_for`` — the port of
``mxnet_tpu/symbol/int8_pass.py`` (MXNet's ``quantize_graph_pass.cc``
through the subgraph-backend seam).

``sym.optimize_for("INT8")`` swaps every eligible ``FullyConnected`` node
for the int8 chain

    quantize_v2(data) + quantize_v2(weight)
        -> quantized_fully_connected (int8 x int8 -> int32)
        -> dequantize (+ the float bias)

as ``contrib.quantization.quantize_net`` does for Gluon blocks.  The
rewritten head keeps the node's name, so ``internals["fc_output"]`` and
argument binding still resolve.  ``calib_ranges={node_name: (min, max)}``
become the data quantizer's static attributes (else its range is each
batch's); nodes in ``excluded_sym_names`` stay float.  The head records
``__int8_quantized_nodes__``.
"""

from __future__ import annotations

from .symbol import Symbol, register_backend


def _op_name(node):
    if node._op is None:
        return None
    return node._op if isinstance(node._op, str) else node._op.name


def _truthy(v):
    return str(v).lower() in ("1", "true")


@register_backend("INT8")
def int8_pass(sym, args=None, aux=None, excluded_sym_names=(),
              calib_ranges=None, **kwargs):  # noqa: ARG001
    from .. import symbol as S
    excluded = set(excluded_sym_names or ())
    calib = dict(calib_ranges or {})
    mapping = {}
    quantized = 0
    for node in sym._walk():
        new_inputs = [mapping.get(id(i), i) for i in node._inputs]
        if _op_name(node) == "FullyConnected" and node._name not in excluded:
            data, weight = new_inputs[0], new_inputs[1]
            no_bias = _truthy(node._attrs.get("no_bias", False))
            bias = new_inputs[2] if (len(new_inputs) > 2 and not no_bias) \
                else None
            dkw = {}
            if node._name in calib:
                dkw = {"min_calib_range": float(calib[node._name][0]),
                       "max_calib_range": float(calib[node._name][1])}
            qx = S.contrib.quantize_v2(data, name=node._name + "_qdata",
                                       **dkw)
            qw = S.contrib.quantize_v2(weight, name=node._name + "_qweight")
            o = S.contrib.quantized_fully_connected(
                qx[0], qw[0], qx[1], qx[2], qw[1], qw[2],
                num_hidden=int(node._attrs.get("num_hidden", 0)),
                flatten=_truthy(node._attrs.get("flatten", True)),
                name=node._name + "_quantized")
            out = S.contrib.dequantize(o[0], o[1], o[2],
                                       name=node._name + "_dequantize")
            if bias is not None:
                out = S.broadcast_add(out, bias,
                                      name=node._name + "_bias_add")
            out._name = node._name
            mapping[id(node)] = out
            quantized += 1
        elif node._op is None or new_inputs == node._inputs:
            mapping[id(node)] = node
        else:
            mapping[id(node)] = Symbol(
                op=node._op, inputs=new_inputs, attrs=dict(node._attrs),
                name=node._name, num_outputs=node._num_outputs,
                out_index=node._out_index)
    out = mapping[id(sym)]
    out._set_attr(__int8_quantized_nodes__=str(quantized))
    return out
