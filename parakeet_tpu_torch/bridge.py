"""Load a flattened flax variable tree into a port module.

The flat form is what ``parakeet_tpu/training/checkpoint.py::flatten_tree``
writes: ``{"params::encoder::layer_0::self_attn::q::kernel": array, ...,
"batch_stats::postnet::bn_0::mean": array}``.  The port's submodules carry
the flax module names, so the middle of a key is the torch module path and
its last part the flax leaf, converted by the torch module's type:

- ``nn.Linear``: kernel (in..., out...) -> weight (out, in); this covers
  ``Dense`` (in, out) and ``DenseGeneral`` q/k/v (d, H, dk) and out
  (H, dk, d), whose biases are flattened.
- ``nn.Conv1d``: kernel (k, Cin, Cout) -> weight (Cout, Cin, k).
- ``nn.LayerNorm`` / ``nn.BatchNorm1d``: scale -> weight, bias -> bias;
  ``batch_stats`` mean / var -> running_mean / running_var.
- ``nn.Embedding``: embedding -> weight.
- any other module: the leaf is a parameter of that name, copied as it is
  (the PWG modules keep the flax layouts).

Every key must land and every parameter and BatchNorm statistic of the
module must be written: anything missing or unused raises ``KeyError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_params"]

_SEP = "::"


def _linear_kernel(mod: nn.Linear, a: np.ndarray) -> np.ndarray:
    return a.reshape(mod.in_features, mod.out_features).T


def _conv_kernel(mod: nn.Conv1d, a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 1, 0)


def _flat(mod: nn.Module, a: np.ndarray) -> np.ndarray:
    return a.reshape(-1)


def _same(mod: nn.Module, a: np.ndarray) -> np.ndarray:
    return a


# torch type -> {(collection, flax leaf): (torch tensor name, convert)}
_RULES: Dict[type, Dict[Tuple[str, str], Tuple[str, Callable]]] = {
    nn.Linear: {("params", "kernel"): ("weight", _linear_kernel),
                ("params", "bias"): ("bias", _flat)},
    nn.Conv1d: {("params", "kernel"): ("weight", _conv_kernel),
                ("params", "bias"): ("bias", _same)},
    nn.LayerNorm: {("params", "scale"): ("weight", _same),
                   ("params", "bias"): ("bias", _same)},
    nn.BatchNorm1d: {("params", "scale"): ("weight", _same),
                     ("params", "bias"): ("bias", _same),
                     ("batch_stats", "mean"): ("running_mean", _same),
                     ("batch_stats", "var"): ("running_var", _same)},
    nn.Embedding: {("params", "embedding"): ("weight", _same)},
}


def _rule(mod: nn.Module, collection: str, leaf: str):
    """(torch tensor name, convert) for one flax leaf, or None."""
    for typ, rules in _RULES.items():
        if isinstance(mod, typ):
            return rules.get((collection, leaf))
    return (leaf, _same) if collection == "params" else None


def _targets(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor a checkpoint must provide: parameters and BatchNorm
    running statistics."""
    out = dict(module.named_parameters())
    for path, mod in module.named_modules():
        if isinstance(mod, nn.BatchNorm1d):
            for name in ("running_mean", "running_var"):
                out[f"{path}.{name}" if path else name] = getattr(mod, name)
    return out


@torch.no_grad()
def load_flax_params(module: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat`` (``flatten_tree`` form) into ``module`` in place,
    casting to each tensor's dtype and device."""
    targets = _targets(module)
    written = set()
    unused = []
    for key, value in flat.items():
        parts = key.split(_SEP)
        collection, path, leaf = parts[0], parts[1:-1], parts[-1]
        try:
            mod = module.get_submodule(".".join(path))
        except AttributeError:
            unused.append(key)
            continue
        rule = _rule(mod, collection, leaf)
        name = ".".join(path + [rule[0]]) if rule else None
        if name not in targets:
            unused.append(key)
            continue
        src = torch.from_numpy(np.ascontiguousarray(
            rule[1](mod, np.asarray(value))))
        dst = targets[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: flax shape {np.shape(value)} gives "
                             f"{tuple(src.shape)}, but {name} is "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
        written.add(name)
    missing = sorted(set(targets) - written)
    if unused or missing:
        raise KeyError(f"flax keys with no counterpart: {sorted(unused)}; "
                       f"module tensors not in the checkpoint: {missing}")
