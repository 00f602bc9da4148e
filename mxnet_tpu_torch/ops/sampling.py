"""Random sampling operators (counterpart of ``mxnet_tpu/ops/sampling.py``):
uniform, normal, gamma, exponential, poisson and negative binomial, each
under the reference's names and aliases (20 names), with its ``shape``,
``dtype`` and ``ctx`` attributes.

A sampler takes no input and draws from the ``generator`` it is handed
(:func:`mxnet_tpu_torch.random.generator` of the device it runs on: the
current context's in ``mx.nd``, the executor's in a bound graph), so
its result lies on that generator's device.  Draws are made in float32
and cast to ``dtype``; the negative binomial is a gamma draw, then a
poisson draw at that rate, as the reference's.  The numbers differ from
the reference's ``jax.random`` streams; their distributions are the
same.
"""
from __future__ import annotations

import torch

from .init_ops import _parse_ctx
from .registry import AttrSpec, Dtype, Float, Shape, register, register_alias


def _empty(attrs, generator):
    return torch.empty(tuple(attrs["shape"] or ()), dtype=torch.float32,
                       device=generator.device)


def _gamma(alpha, shape, generator):
    """Standard gamma draws of shape ``alpha`` (scale 1)."""
    return torch._standard_gamma(
        torch.full(shape, float(alpha), device=generator.device),
        generator=generator)


def _uniform(attrs, g):
    return _empty(attrs, g).uniform_(attrs["low"], attrs["high"],
                                     generator=g)


def _normal(attrs, g):
    return attrs["loc"] + attrs["scale"] * _empty(attrs, g).normal_(
        generator=g)


def _gamma_op(attrs, g):
    return _gamma(attrs["alpha"], _empty(attrs, g).shape, g) * attrs["beta"]


def _exponential(attrs, g):
    return _empty(attrs, g).exponential_(generator=g) / attrs["lam"]


def _poisson(attrs, g):
    return torch.poisson(torch.full_like(_empty(attrs, g), attrs["lam"]),
                         generator=g)


def _negbinomial(attrs, g):
    k, p = attrs["k"], attrs["p"]
    lam = _gamma(k, _empty(attrs, g).shape, g) * ((1 - p) / max(p, 1e-12))
    return torch.poisson(lam, generator=g)


def _register_sampler(name, draw, extra_attrs, aliases):
    def fc(attrs, generator=None):
        return draw(attrs, generator).to(getattr(torch, attrs["dtype"] or
                                                 "float32"))

    attrs = {"shape": Shape(None), "dtype": Dtype("float32"),
             "ctx": AttrSpec(_parse_ctx, None, False)}
    attrs.update(extra_attrs)
    register(name, fcompute=fc, arguments=(), needs_rng=True, attrs=attrs,
             infer_shape=lambda attrs, ins: (
                 [], [tuple(attrs["shape"] or ())], []),
             infer_type=lambda attrs, ts: (
                 [], [attrs["dtype"] or "float32"], []),
             doc="Draws of `shape` and `dtype` from the %s distribution."
                 % name.rpartition("_")[2])
    for alias in aliases:
        register_alias(name, alias)


_register_sampler("_sample_uniform", _uniform,
                  {"low": Float(0.0), "high": Float(1.0)},
                  ("uniform", "_random_uniform", "random_uniform"))
_register_sampler("_sample_normal", _normal,
                  {"loc": Float(0.0), "scale": Float(1.0)},
                  ("normal", "_random_normal", "random_normal"))
_register_sampler("_sample_gamma", _gamma_op,
                  {"alpha": Float(1.0), "beta": Float(1.0)},
                  ("_random_gamma", "random_gamma"))
_register_sampler("_sample_exponential", _exponential, {"lam": Float(1.0)},
                  ("_random_exponential", "random_exponential"))
_register_sampler("_sample_poisson", _poisson, {"lam": Float(1.0)},
                  ("_random_poisson", "random_poisson"))
_register_sampler("_sample_negbinomial", _negbinomial,
                  {"k": Float(1.0), "p": Float(1.0)},
                  ("_random_negbinomial", "random_negative_binomial"))
