"""Sampling operators — the port of ``mxnet_tpu/ops/random_ops.py``: the
``random.*`` samplers (``mx.nd.random.uniform`` ...), the ``sample_*``
samplers that take one parameter array per distribution parameter,
``sample_multinomial``, ``shuffle`` and ``gumbel_softmax``.

Each declares ``wrap_key="_generator"``: dispatch passes the device's
``torch.Generator`` (``mxnet_tpu_torch.random.generator``), so
``mx.random.seed(s)`` makes every draw reproducible on that device, and the
samples are created on the generator's device (the card unless the caller
asks for the host).  Parity with the reference is in distribution, not bit
for bit.  ``randint`` with the default dtype ``"float32"`` returns int32,
as the reference's does.
"""

from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import register


def _gamma(alpha, shape, gen):
    """Gamma(alpha, 1) draws of ``shape``; ``alpha`` a number or a tensor
    that broadcasts to ``shape``."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=gen.device) \
        .expand(shape).contiguous()
    return torch._standard_gamma(a, generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


def _sampler(name, draw):
    def impl(shape=(), dtype="float32", _generator=None, **kw):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return draw(_generator, shape, dtype, **kw)
    impl.__name__ = name
    impl.__doc__ = draw.__doc__
    register(name, differentiable=False, wrap_key="_generator")(impl)


def _uniform(gen, shape, dtype, low=0.0, high=1.0):
    """Uniform on [low, high)."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch_dtype(dtype))
    return u * (high - low) + low


def _normal(gen, shape, dtype, loc=0.0, scale=1.0):
    """Normal(loc, scale)."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch_dtype(dtype)) * scale + loc


def _gamma_draw(gen, shape, dtype, alpha=1.0, beta=1.0):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return (_gamma(alpha, shape, gen) * beta).to(torch_dtype(dtype))


def _exponential(gen, shape, dtype, lam=1.0):
    """Exponential with rate ``lam``."""
    return torch.empty(shape, device=gen.device, dtype=torch_dtype(dtype)) \
        .exponential_(lam, generator=gen)


def _poisson_draw(gen, shape, dtype, lam=1.0):
    """Poisson with rate ``lam``."""
    rate = torch.full(shape, float(lam), device=gen.device)
    return _poisson(rate, gen).to(torch_dtype(dtype))


def _randint(gen, shape, dtype, low=0, high=100):
    """Integers uniform on [low, high); int32 for the default "float32"."""
    dt = torch.int32 if dtype == "float32" else torch_dtype(dtype)
    return torch.randint(int(low), int(high), shape, generator=gen,
                         device=gen.device, dtype=dt)


def _negbin_rate(gen, shape, r, p):
    """Poisson rates of a negative binomial: Gamma(r) (1 - p) / p."""
    return _gamma(r, shape, gen) * (1 - p) / p


def _negative_binomial(gen, shape, dtype, k=1, p=1.0):
    """Failures before the k-th success of a Bernoulli(p) (a Gamma-Poisson
    mixture)."""
    return _poisson(_negbin_rate(gen, shape, k, p), gen) \
        .to(torch_dtype(dtype))


def _gen_negative_binomial(gen, shape, dtype, mu=1.0, alpha=1.0):
    """Negative binomial with mean ``mu`` and dispersion ``alpha``."""
    r = 1.0 / alpha
    return _poisson(_negbin_rate(gen, shape, r, r / (r + mu)), gen) \
        .to(torch_dtype(dtype))


def _bernoulli(gen, shape, dtype, p=0.5):
    """1 with probability ``p``, else 0."""
    probs = torch.full(shape, float(p), device=gen.device)
    return torch.bernoulli(probs, generator=gen).to(torch_dtype(dtype))


for _name, _draw in (("uniform", _uniform), ("normal", _normal),
                     ("gamma", _gamma_draw), ("exponential", _exponential),
                     ("poisson", _poisson_draw), ("randint", _randint),
                     ("negative_binomial", _negative_binomial),
                     ("generalized_negative_binomial",
                      _gen_negative_binomial),
                     ("bernoulli", _bernoulli)):
    _sampler(f"random.{_name}", _draw)


# -- one parameter array per distribution parameter ---------------------------

def _esampler(name, draw):
    """``sample_*``: parameter arrays of one shape P; the output is
    P + ``shape``, ``shape`` draws per parameter set."""
    def impl(*params, shape=(), dtype="float32", _generator=None):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        tail = (1,) * len(shape)
        ps = [p.reshape(p.shape + tail) for p in params]
        return draw(_generator, params[0].shape + shape, torch_dtype(dtype),
                    *ps)
    impl.__name__ = name
    register(name, differentiable=False, wrap_key="_generator")(impl)


_esampler("sample_uniform", lambda g, shape, dt, low, high: torch.rand(
    shape, generator=g, device=g.device, dtype=dt) * (high - low) + low)
_esampler("sample_normal", lambda g, shape, dt, mu, sigma: torch.randn(
    shape, generator=g, device=g.device, dtype=dt) * sigma + mu)
_esampler("sample_gamma", lambda g, shape, dt, alpha, beta: (
    _gamma(alpha.float(), shape, g) * beta).to(dt))
_esampler("sample_exponential", lambda g, shape, dt, lam: torch.empty(
    shape, device=g.device, dtype=dt).exponential_(1.0, generator=g) / lam)
_esampler("sample_poisson", lambda g, shape, dt, lam: _poisson(
    lam.float().expand(shape).contiguous(), g).to(dt))


def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        _generator=None):
    """Category indices drawn from the probabilities ``data`` (..., k):
    output data.shape[:-1] + ``shape``; with ``get_prob`` also the log
    probability of each draw."""
    if isinstance(shape, int):
        shp = (shape,) if shape else ()
    else:
        shp = tuple(shape)
    n = math.prod(shp) if shp else 1
    probs = data.reshape(-1, data.shape[-1]).float()
    draw = torch.multinomial(probs, n, replacement=True, generator=_generator)
    draw = draw.reshape(data.shape[:-1] + shp)
    out = draw.to(torch_dtype(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(data.clamp(min=1e-37)), dim=-1)
    flat = logp.reshape(-1, data.shape[-1])
    lp = torch.gather(flat, 1, draw.reshape(flat.shape[0], n))
    return [out, lp.reshape(draw.shape).to(data.dtype)]


register("sample_multinomial", differentiable=False,
         wrap_key="_generator")(_sample_multinomial)
register("random.multinomial", differentiable=False,
         wrap_key="_generator")(_sample_multinomial)


@register("shuffle", differentiable=False, wrap_key="_generator")
def _shuffle(data, _generator=None):
    """``data`` with its rows (axis 0) in a random order."""
    perm = torch.randperm(data.shape[0], generator=_generator,
                          device=data.device)
    return data[perm]


@register("gumbel_softmax", wrap_key="_generator")
def _gumbel_softmax(logits, tau=1.0, hard=False, _generator=None):
    """softmax((logits + Gumbel noise) / tau) over the last axis; with
    ``hard`` the one-hot of its argmax forward and the soft gradient
    backward (straight through)."""
    u = torch.rand(logits.shape, generator=_generator, device=logits.device,
                   dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((logits + g) / tau, dim=-1)
    if hard:
        idx = torch.argmax(y, dim=-1, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(-1, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y
