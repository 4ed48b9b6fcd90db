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
``flax_arrays`` is the inverse (a ``DenseGeneral`` kernel comes back 2-D,
which ``load_flax_params`` reshapes).

The train state crosses too, in both directions, under the keys of the
JAX ``TrainState`` that ``parakeet_tpu.training.checkpoint.flatten_tree``
writes (``train_state_arrays`` / ``load_train_state``):

- ``step``;
- ``params::<module>::...`` (and ``batch_stats::<module>::...``) for each
  module of ``TrainState.modules``;
- the Adam moments and count of ``build_optimizer``'s optax chain,
  ``opt_state::<module>::<chain index>::{count, mu::..., nu::...}``, onto
  ``torch.optim.Adam``'s ``step``, ``exp_avg`` and ``exp_avg_sq`` (and the
  learning-rate schedule's position).

The JAX ``rng`` leaf cannot cross: a JAX key is not a ``torch.Generator``
state.  The port stores its generator's state under ``torch_rng`` instead;
loading a snapshot without it (one the JAX package wrote) reseeds the
generator from its initial seed, the config's seed that
``seed_everything`` gave it, so the noise stream restarts.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_params", "flax_arrays", "train_state_arrays",
           "load_train_state", "RNG_KEY"]

_SEP = "::"
RNG_KEY = "torch_rng"


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


# each converter's inverse (torch layout -> flax layout)
_TO_FLAX = {_linear_kernel: lambda a: a.T,
            _conv_kernel: lambda a: a.transpose(2, 1, 0),
            _flat: lambda a: a, _same: lambda a: a}


def _inverse_rule(mod: nn.Module, name: str) -> Tuple[str, str, Callable]:
    """(collection, flax leaf, torch -> flax converter) of a tensor of
    ``mod``."""
    for typ, rules in _RULES.items():
        if isinstance(mod, typ):
            for (collection, leaf), (tname, conv) in rules.items():
                if tname == name:
                    return collection, leaf, _TO_FLAX[conv]
            break
    return "params", name, _TO_FLAX[_same]


def _flax_leaves(module: nn.Module) -> Iterator[Tuple[str, str, torch.Tensor,
                                                      Callable]]:
    """(flax key, torch name, tensor, torch -> flax converter) of every
    parameter and BatchNorm statistic of ``module``."""
    for name, tensor in _targets(module).items():
        path, _, leaf = name.rpartition(".")
        mod = module.get_submodule(path)
        collection, fleaf, conv = _inverse_rule(mod, leaf)
        parts = [collection] + (path.split(".") if path else []) + [fleaf]
        yield _SEP.join(parts), name, tensor, conv


@torch.no_grad()
def flax_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``load_flax_params``: ``module``'s parameters and
    BatchNorm statistics as a flat flax tree of host float32 arrays."""
    return {key: np.ascontiguousarray(conv(t.detach().float().cpu().numpy()))
            for key, _, t, conv in _flax_leaves(module)}


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


def _adam(opt) -> torch.optim.Optimizer:
    inner = opt.inner
    if not isinstance(inner, torch.optim.Adam) or any(
            g.get("amsgrad") for g in inner.param_groups):
        raise NotImplementedError(
            f"the train state crosses with Adam or AdamW (no amsgrad) only, "
            f"not {type(inner).__name__}")
    return inner


def _adam_prefix(opt) -> str:
    """Index path of optax's adam state in ``build_optimizer``'s chain:
    clip_by_global_norm, then add_decayed_weights (not for adamw, whose
    decay is inside its own chain), then the optimizer."""
    inner = _adam(opt)
    parts = []
    if opt.max_grad_norm:
        parts.append("1")
    if (not isinstance(inner, torch.optim.AdamW)
            and inner.defaults.get("weight_decay")):
        parts.append("1")
    return _SEP.join(parts + ["0"])


def _param_keys(module: nn.Module):
    """{parameter: (flax key without the 'params' collection, converter)}
    of ``module``'s parameters."""
    params = {id(p): p for p in module.parameters()}
    out = {}
    for key, _, t, conv in _flax_leaves(module):
        if id(t) in params and key.startswith("params" + _SEP):
            out[t] = (key[len("params" + _SEP):], conv)
    return out


@torch.no_grad()
def train_state_arrays(state) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` as the JAX ``TrainState``'s flat keys (see the
    module docstring), plus the generator's state under ``RNG_KEY``."""
    flat = {"step": np.asarray(state.step, np.int32)}
    for name, module in state.modules.items():
        for key, a in flax_arrays(module).items():
            collection, rest = key.split(_SEP, 1)
            flat[_SEP.join((collection, name, rest))] = a
        opt = state.optimizers.get(name)
        if opt is None:
            continue
        inner = _adam(opt)
        prefix = _SEP.join(("opt_state", name, _adam_prefix(opt)))
        count = 0
        for p, (key, conv) in _param_keys(module).items():
            st = inner.state.get(p, {})
            if st:
                count = int(st["step"])
                mu, nu = st["exp_avg"], st["exp_avg_sq"]
            else:                       # never stepped: optax's zeros
                mu = nu = torch.zeros_like(p)
            for moment, value in (("mu", mu), ("nu", nu)):
                flat[_SEP.join((prefix, moment, key))] = np.ascontiguousarray(
                    conv(value.detach().float().cpu().numpy()))
        flat[_SEP.join((prefix, "count"))] = np.asarray(count, np.int32)
    if state.rng is not None:
        flat[RNG_KEY] = state.rng.get_state().numpy()
    return flat


def _find_adam_prefix(flat, name: str) -> str:
    head = _SEP.join(("opt_state", name)) + _SEP
    found = [k[:-len(_SEP + "count")] for k in flat
             if k.startswith(head) and k.endswith(_SEP + "count")]
    if len(found) != 1:
        raise KeyError(f"expected one Adam count under {head!r}, found "
                       f"{found}")
    return found[0]


@torch.no_grad()
def load_train_state(state, flat: Dict[str, np.ndarray]) -> None:
    """Load a flat train state (the port's snapshot or the JAX package's)
    into ``state`` in place: parameters, Adam moments and counts (on each
    parameter's device), the schedules' position, the step, and the
    generator's state (reseeded from its initial seed when ``flat`` has
    none).  Every module's and optimizer's tensors must be present."""
    for name, module in state.modules.items():
        own = {}
        for key, value in flat.items():
            collection, _, rest = key.partition(_SEP)
            if collection in ("params", "batch_stats") and rest.startswith(
                    name + _SEP):
                own[_SEP.join((collection, rest[len(name + _SEP):]))] = value
        load_flax_params(module, own)
        opt = state.optimizers.get(name)
        if opt is None:
            continue
        inner = _adam(opt)
        prefix = _find_adam_prefix(flat, name)
        count = int(flat[_SEP.join((prefix, "count"))])
        for p, (key, _) in _param_keys(module).items():
            mod_path, _, leaf = key.rpartition(_SEP)
            mod = module.get_submodule(mod_path.replace(_SEP, "."))
            _, from_flax = _rule(mod, "params", leaf)
            moments = []
            for moment in ("mu", "nu"):
                a = np.asarray(flat[_SEP.join((prefix, moment, key))])
                moments.append(torch.from_numpy(np.ascontiguousarray(
                    from_flax(mod, a))).to(p.device, p.dtype).reshape(
                        p.shape))
            inner.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": moments[0],
                              "exp_avg_sq": moments[1]}
        sched = opt.scheduler
        sched.last_epoch = count
        for group, base, fn in zip(inner.param_groups, sched.base_lrs,
                                   sched.lr_lambdas):
            group["lr"] = base * fn(count)
        sched._last_lr = [g["lr"] for g in inner.param_groups]
    state.step = int(flat["step"])
    if state.rng is not None:
        if RNG_KEY in flat:
            state.rng.set_state(torch.from_numpy(
                np.ascontiguousarray(flat[RNG_KEY])))
        else:
            state.rng.manual_seed(state.rng.initial_seed())
