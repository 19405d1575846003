"""``mx.viz`` — network visualization, the port of
``mxnet_tpu/visualization.py`` (MXNet's ``python/mxnet/visualization.py``).

``print_summary(symbol, shape=...)`` prints the reference's layer table
(name, output shape, parameter count, previous layers) and returns the
total parameter count; ``plot_network`` builds a graphviz ``Digraph``
when the ``graphviz`` package is importable and raises with guidance
otherwise.
"""

from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def _node_params(sym, shape_of, data_names):
    """A node's parameter count: the sizes of its variable inputs that are
    neither auxiliary states nor the data the caller gave shapes for."""
    total = 0
    for i in sym._inputs:
        if i._op is None and not i._attrs.get("__aux__") \
                and i._name not in data_names:
            shp = shape_of.get(i._name)
            if shp:
                total += int(math.prod(shp))
    return total


def print_summary(symbol, shape=None, line_length=98, positions=None):
    """Print the layer table of ``symbol``; ``shape`` (input name ->
    shape) lets it infer the output shapes and parameter counts.
    Returns the total parameter count."""
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    arg_shapes = {}
    out_shape_of = {}
    data_names = set(shape or {})
    if shape:
        internals = symbol.get_internals()
        arg_s, out_s, _ = internals.infer_shape(**shape)
        if arg_s is not None:
            arg_shapes = dict(zip(internals.list_arguments(), arg_s))
        # a node with several outputs gives out_s that many entries: keep
        # the first (the visible one)
        pos = 0
        for node in internals._inputs:
            if out_s is not None and pos < len(out_s):
                out_shape_of[node._name] = out_s[pos]
            pos += node.num_outputs

    cols = [int(line_length * p) for p in positions]

    def row(fields):
        line = ""
        for text, col in zip(fields, cols):
            line = (line + str(text))[:col - 1].ljust(col)
        print(line)

    print("=" * line_length)
    row(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)
    total = 0
    for s in symbol._walk():
        if s._op is None:
            continue
        op_name = s._op if isinstance(s._op, str) else s._op.name
        n_par = _node_params(s, arg_shapes, data_names)
        total += n_par
        prev = ",".join(i._name for i in s._inputs if i._op is not None) \
            or ",".join(i._name for i in s._inputs[:1])
        row([f"{s._name} ({op_name})", out_shape_of.get(s._name, ""), n_par,
             prev])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("=" * line_length)
    return total


def plot_network(symbol, title="plot", shape=None, node_attrs=None,
                 save_format="pdf"):  # noqa: ARG001
    """A graphviz ``Digraph`` of the graph (needs the ``graphviz``
    package)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise MXNetError(
            "plot_network needs the `graphviz` python package (not in this "
            "environment); use print_summary for a text view") from e
    dot = Digraph(name=title, format=save_format)
    for s in symbol._walk():
        label = s._name if s._op is None else \
            f"{s._name}\\n{(s._op if isinstance(s._op, str) else s._op.name)}"
        dot.node(str(id(s)), label,
                 shape="oval" if s._op is None else "box")
        for i in s._inputs:
            dot.edge(str(id(i)), str(id(s)))
    return dot
