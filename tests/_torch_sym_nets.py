"""Symbolic nets the ``test_torch_{symbol,module,symbol_block}.py`` files
build alike in both packages: each builder takes the package
(``mxnet_tpu`` or ``mxnet_tpu_torch``) and starts its own NameManager, so
the auto-names agree.  ``params(sym, shapes, seed)`` gives seeded numpy
values for every argument and auxiliary state."""

import numpy as np


def mlp(pkg, hidden=32, classes=4):
    sym = pkg.sym
    with pkg.name.NameManager():
        net = sym.FullyConnected(sym.var("data"), num_hidden=hidden,
                                 name="fc1")
        net = sym.Activation(net, act_type="relu", name="relu1")
        net = sym.FullyConnected(net, num_hidden=classes, name="fc2")
        return sym.SoftmaxOutput(net, name="softmax")


def bn_net(pkg, classes=3):
    sym = pkg.sym
    with pkg.name.NameManager():
        # no bias before BatchNorm: its gradient is rounding noise, which
        # Adam would scale up to whole steps
        net = sym.Convolution(sym.var("data"), kernel=(3, 3), pad=(1, 1),
                              num_filter=4, no_bias=True, name="c1")
        net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = sym.relu(net)
        net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
        net = sym.FullyConnected(net, num_hidden=classes, name="fc")
        return sym.SoftmaxOutput(net, name="softmax")


def encoder(pkg, vocab=50, units=16, heads=2, ffn=32, layers=1,
            max_len=256):
    """A post-LN encoder (token and position Embedding, interleaved qkv,
    ``contrib.masked_selfatt`` with ``valid_length``, GELU FFN, a head
    over every position into SoftmaxOutput), at small widths."""
    sym = pkg.sym
    with pkg.name.NameManager():
        data, vl = sym.var("data"), sym.var("valid_length")
        tok = sym.Embedding(data, input_dim=vocab, output_dim=units,
                            name="word_embed")
        pos = sym.Embedding(sym.contrib.arange_like(data, axis=1),
                            input_dim=max_len, output_dim=units,
                            name="pos_embed")
        x = sym.LayerNorm(sym.broadcast_add(tok, pos), name="embed_ln")
        x = sym.transpose(x, axes=(1, 0, 2))
        for i in range(layers):
            qkv = sym.FullyConnected(x, num_hidden=3 * units, flatten=False,
                                     name=f"l{i}_qkv")
            att = sym.contrib.masked_selfatt(qkv, vl, heads=heads,
                                             name=f"l{i}_att")
            proj = sym.FullyConnected(att, num_hidden=units, flatten=False,
                                      name=f"l{i}_proj")
            x = sym.LayerNorm(x + proj, name=f"l{i}_ln1")
            h = sym.FullyConnected(x, num_hidden=ffn, flatten=False,
                                   name=f"l{i}_ffn1")
            h = sym.LeakyReLU(h, act_type="gelu", name=f"l{i}_gelu")
            h = sym.FullyConnected(h, num_hidden=units, flatten=False,
                                   name=f"l{i}_ffn2")
            x = sym.LayerNorm(x + h, name=f"l{i}_ln2")
        x = sym.transpose(x, axes=(1, 0, 2))
        logits = sym.FullyConnected(x, num_hidden=vocab, flatten=False,
                                    name="head")
        return sym.SoftmaxOutput(logits, name="softmax")


NETS = {
    "mlp": (mlp, {"data": (8, 10), "softmax_label": (8,)}),
    "bn": (bn_net, {"data": (4, 2, 6, 6), "softmax_label": (4,)}),
    "encoder": (encoder, {"data": (2, 256), "valid_length": (2,),
                          "softmax_label": (2, 256)}),
}


def inputs(sym, shapes, seed=0, vocab=50):
    """Seeded numpy values for every argument and auxiliary state of
    ``sym`` (the shapes inferred from ``shapes``): weights N(0, 0.1^2),
    norm scales and variances 1, token ids and labels in range, valid
    lengths below the sequence length."""
    rng = np.random.RandomState(seed)
    args, _, auxs = sym.infer_shape(**shapes)
    vals = {}
    for name, shp in zip(sym.list_arguments() + sym.list_auxiliary_states(),
                         args + auxs):
        if name.endswith(("gamma", "moving_var")):
            v = 1.0 + 0.1 * rng.rand(*shp)
        elif name.endswith("moving_mean"):
            v = 0.1 * rng.randn(*shp)
        elif name == "softmax_label":
            top = vocab if len(shp) > 1 else 3
            v = rng.randint(0, top, shp)
        elif name == "data" and len(shp) == 2 and "valid_length" in shapes:
            v = rng.randint(0, vocab, shp)
        elif name == "valid_length":
            v = rng.randint(shapes["data"][1] // 2, shapes["data"][1] + 1,
                            shp)
        else:
            v = 0.1 * rng.randn(*shp)
        vals[name] = np.asarray(v, np.float32)
    return vals
