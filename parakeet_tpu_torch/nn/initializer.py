"""Weight initialization on an explicit ``torch.Generator`` (counterpart of
``parakeet_tpu/nn/initializer.py`` and of the flax default initializers
the JAX modules draw their parameters from).

``initialize_`` is ``initialize_pytree``: the recipe's ``init_type``
redraws every parameter whose leaf in the JAX module's flax tree has rank
2 or more (dense, DenseGeneral and conv kernels, embeddings, and the
attention projections' (heads, dk) biases) and leaves every other one.
Fans follow the flax convention on the flax shape (the last axis out,
the one before it in, the rest a receptive field), which the bridge's
layouts give: a torch ``Linear`` (out, in) is flax (in, out), or (d, H,
dk) for an attention's q/k/v and (H, dk, d) for its out; a ``Conv1d``
(out, in, k) is (k, in, out); an ``Embedding`` (num, dim) is ``Embed``
(num, dim); an LSTM cell's ``weight_ih`` and ``weight_hh`` (4H, in) are
four flax kernels (in, H) of the same fans, one a gate.  The draws
differ from JAX's, whose generator differs; the set of redrawn
parameters and each one's distribution do not.

``init_flax_defaults_`` gives a freshly built module the values flax's
defaults would: kernels lecun-normal over their fan-in, an LSTM cell's
recurrent kernels orthogonal, embeddings N(0, 1 / dim), biases zero,
normalization scales one (a positional encoding's alpha keeps its
initial value).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from .transformer import MultiHeadAttention

__all__ = ["INIT_SCHEMES", "flax_shapes", "initialize_",
           "init_flax_defaults_"]

# init_type -> (scale, mode, distribution) of jax.nn.initializers
# .variance_scaling: glorot_uniform, glorot_normal, he_uniform, he_normal
INIT_SCHEMES = {
    "xavier_uniform": (1.0, "fan_avg", "uniform"),
    "xavier_normal": (1.0, "fan_avg", "truncated_normal"),
    "kaiming_uniform": (2.0, "fan_in", "uniform"),
    "kaiming_normal": (2.0, "fan_in", "truncated_normal"),
}
# the standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def flax_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{parameter name: the shape of its leaf in the flax tree}."""
    heads = {}
    for path, mod in module.named_modules():
        if isinstance(mod, MultiHeadAttention):
            hd = (mod.n_heads, mod.d_model // mod.n_heads)
            for child in ("q", "k", "v", "out"):
                heads[f"{path}.{child}" if path else child] = (child, hd)
    shapes = {}
    for path, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(mod, nn.Linear):
                child, hd = heads.get(path, (None, None))
                if child == "out":
                    shape = (*hd, mod.out_features) if name == "weight" \
                        else shape
                elif child is not None:
                    shape = (mod.in_features, *hd) if name == "weight" \
                        else hd
                elif name == "weight":
                    shape = (mod.in_features, mod.out_features)
            elif isinstance(mod, nn.Conv1d) and name == "weight":
                shape = (shape[2], shape[1], shape[0])
            elif isinstance(mod, nn.LSTMCell) and name != "bias_hh":
                # one gate's flax kernel (in, H); the four share its fans
                shape = (shape[1], mod.hidden_size)
            shapes[f"{path}.{name}" if path else name] = shape
    return shapes


def _fans(shape):
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _scheme(shape, init_type):
    """(distribution, its parameter: the uniform's limit or the truncated
    normal's standard deviation before truncation)."""
    if init_type not in INIT_SCHEMES:
        raise ValueError(f"Unknown initialization: {init_type} "
                         f"(choose from {sorted(INIT_SCHEMES)})")
    scale, mode, dist = INIT_SCHEMES[init_type]
    fan_in, fan_out = _fans(shape)
    variance = scale / (fan_in if mode == "fan_in"
                        else (fan_in + fan_out) / 2)
    if dist == "uniform":
        return dist, math.sqrt(3.0 * variance)
    return dist, math.sqrt(variance) / _TRUNC_STD


def _draw(shape, dist, param, gen):
    value = torch.empty(shape, dtype=torch.float32)
    if dist == "uniform":
        return value.uniform_(-param, param, generator=gen)
    if dist == "normal":
        return value.normal_(0.0, param, generator=gen)
    return nn.init.trunc_normal_(value, 0.0, param, -2.0 * param,
                                 2.0 * param, generator=gen)


@torch.no_grad()
def initialize_(module: nn.Module, gen: torch.Generator,
                init_type: str) -> List[str]:
    """Redraw, from ``gen`` (a CPU generator), every parameter of
    ``module`` whose flax leaf has rank >= 2, from ``init_type``; returns
    their names."""
    redrawn = []
    params = dict(module.named_parameters())
    for name, shape in flax_shapes(module).items():
        if len(shape) < 2:
            continue
        p = params[name]
        p.copy_(_draw(p.shape, *_scheme(shape, init_type), gen))
        redrawn.append(name)
    return redrawn


@torch.no_grad()
def init_flax_defaults_(module: nn.Module, gen: torch.Generator) -> None:
    """flax's default initializers, drawn from ``gen`` (a CPU generator):
    Dense, DenseGeneral and Conv kernels lecun-normal over their fan-in
    (DenseGeneral's over the flattened input axes, as flax does), Embed
    N(0, 1 / dim), biases zero, LayerNorm and BatchNorm scales one; an
    LSTM cell (flax's ``OptimizedLSTMCell``) takes, gate by gate, a
    lecun-normal input kernel, an orthogonal recurrent kernel and a zero
    bias."""
    for _, mod in module.named_modules():
        if isinstance(mod, nn.LSTMCell):
            h, std = mod.hidden_size, math.sqrt(1.0 / mod.input_size)
            for k in range(4):
                rows = slice(k * h, (k + 1) * h)
                mod.weight_ih[rows] = _draw((h, mod.input_size),
                                            "truncated_normal",
                                            std / _TRUNC_STD, gen)
                mod.weight_hh[rows] = nn.init.orthogonal_(
                    torch.empty(h, h), generator=gen)
            mod.bias_hh.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv1d)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            mod.weight.copy_(_draw(mod.weight.shape, "truncated_normal",
                                   std, gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(_draw(mod.weight.shape, "normal",
                                   math.sqrt(1.0 / mod.embedding_dim), gen))
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
