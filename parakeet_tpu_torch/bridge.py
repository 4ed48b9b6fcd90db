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
- ``nn.LSTMCell`` (flax's ``OptimizedLSTMCell``): flax keeps eight dense
  layers under the cell, ``ii/if/ig/io`` (in, H) kernels without bias and
  ``hi/hf/hg/ho`` (H, H) kernels with bias; they stack by gate, in
  torch's order i, f, g, o, into ``weight_ih`` and ``weight_hh`` (4H, .)
  and ``bias_hh``.  The cell must have no ``bias_ih`` parameter (the
  port's ``nn.rnn.LSTMCell`` keeps a zero buffer there).
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
  module of ``TrainState.modules`` (the GAN's generator and
  discriminator); a state of one module named ``ROOT_MODULE`` keeps its
  tree at the root, ``params::...``, as the JAX TrainState of one model
  does;
- the Adam moments and count of ``build_optimizer``'s optax chain,
  ``opt_state::[<module>::]<chain index>::{count, mu::..., nu::...}``,
  onto ``torch.optim.Adam``'s ``step``, ``exp_avg`` and ``exp_avg_sq``
  (and the learning-rate schedule's position).

The JAX ``rng`` leaf cannot cross: a JAX key is not a ``torch.Generator``
state.  The port stores its generator's state under ``torch_rng`` instead;
loading a snapshot without it (one the JAX package wrote) reseeds the
generator from its initial seed, the config's seed that
``seed_everything`` gave it, so the noise stream restarts.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_params", "flax_arrays", "train_state_arrays",
           "load_train_state", "RNG_KEY", "ROOT_MODULE"]

_SEP = "::"
RNG_KEY = "torch_rng"
# the module name of a one-model state (FastSpeech2, SpeedySpeech,
# Tacotron2): its tree sits at the root of the JAX TrainState's keys
ROOT_MODULE = "model"


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


# flax's OptimizedLSTMCell gates in torch's LSTMCell row order
_LSTM_GATES = ("i", "f", "g", "o")


def _lstm_pieces(mod: nn.LSTMCell):
    """(flax dense layer, flax leaf, torch tensor name, rows, transposed)
    of each flax leaf of an LSTM cell."""
    h = mod.hidden_size
    for k, gate in enumerate(_LSTM_GATES):
        rows = slice(k * h, (k + 1) * h)
        yield f"i{gate}", "kernel", "weight_ih", rows, True
        yield f"h{gate}", "kernel", "weight_hh", rows, True
        yield f"h{gate}", "bias", "bias_hh", rows, False


def _lstm_target(module: nn.Module, collection: str, path, leaf: str):
    """(torch tensor name, rows, transposed) of a flax leaf that lies in an
    LSTM cell's dense layer ``path[-1]``, or None."""
    if collection != "params" or not path:
        return None
    try:
        cell = module.get_submodule(".".join(path[:-1]))
    except AttributeError:
        return None
    if not isinstance(cell, nn.LSTMCell):
        return None
    for dense, fleaf, tname, rows, transposed in _lstm_pieces(cell):
        if (dense, fleaf) == (path[-1], leaf):
            return ".".join(list(path[:-1]) + [tname]), rows, transposed
    return None


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
    flax leaf of ``module``'s parameters and BatchNorm statistics (an LSTM
    cell's tensors give four leaves each)."""
    for name, tensor in _targets(module).items():
        path, _, leaf = name.rpartition(".")
        mod = module.get_submodule(path)
        prefix = path.split(".") if path else []
        if isinstance(mod, nn.LSTMCell):
            for dense, fleaf, tname, rows, transposed in _lstm_pieces(mod):
                if tname == leaf:
                    yield (_SEP.join(["params"] + prefix + [dense, fleaf]),
                           name, tensor, functools.partial(
                               _lstm_to_flax, rows=rows,
                               transposed=transposed))
            continue
        collection, fleaf, conv = _inverse_rule(mod, leaf)
        yield _SEP.join([collection] + prefix + [fleaf]), name, tensor, conv


def _lstm_to_flax(a: np.ndarray, *, rows: slice,
                  transposed: bool) -> np.ndarray:
    return a[rows].T if transposed else a[rows]


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


def _assemble(module: nn.Module, flat: Dict[str, np.ndarray],
              targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{torch name: CPU tensor in the torch layout} of ``flat``'s leaves
    (``flatten_tree`` form) for ``targets`` (a subset of ``_targets``).
    Anything of ``flat`` that lands nowhere, and any target it leaves
    unwritten, raises ``KeyError``; a leaf of the wrong shape raises
    ``ValueError``."""
    out: Dict[str, torch.Tensor] = {}
    pieces: Dict[str, int] = {}
    unused = []
    for key, value in flat.items():
        parts = key.split(_SEP)
        collection, path, leaf = parts[0], parts[1:-1], parts[-1]
        a = np.asarray(value)
        lstm = _lstm_target(module, collection, path, leaf)
        if lstm is not None:
            name, rows, transposed = lstm
            if name not in targets:
                unused.append(key)
                continue
            dst = out.setdefault(name, torch.empty(
                targets[name].shape, dtype=torch.float32))
            src = torch.from_numpy(np.ascontiguousarray(
                a.T if transposed else a)).float()
            if tuple(src.shape) != tuple(dst[rows].shape):
                raise ValueError(f"{key}: flax shape {a.shape} does not fit "
                                 f"rows {rows} of {name} {tuple(dst.shape)}")
            dst[rows] = src
            pieces[name] = pieces.get(name, 0) + 1
            continue
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
        src = torch.from_numpy(np.ascontiguousarray(rule[1](mod, a)))
        if tuple(src.shape) != tuple(targets[name].shape):
            raise ValueError(f"{key}: flax shape {a.shape} gives "
                             f"{tuple(src.shape)}, but {name} is "
                             f"{tuple(targets[name].shape)}")
        out[name] = src
    partial = sorted(n for n, k in pieces.items() if k != len(_LSTM_GATES))
    missing = sorted(set(targets) - set(out)) + partial
    if unused or missing:
        raise KeyError(f"flax keys with no counterpart: {sorted(unused)}; "
                       f"module tensors not in the checkpoint: {missing}")
    return out


@torch.no_grad()
def load_flax_params(module: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat`` (``flatten_tree`` form) into ``module`` in place,
    casting to each tensor's dtype and device."""
    targets = _targets(module)
    for name, src in _assemble(module, flat, targets).items():
        targets[name].copy_(src)


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
    """(parameter, its flax key without the 'params' collection,
    converter) of each flax leaf of ``module``'s parameters."""
    params = {id(p) for p in module.parameters()}
    return [(t, key[len("params" + _SEP):], conv)
            for key, _, t, conv in _flax_leaves(module)
            if id(t) in params and key.startswith("params" + _SEP)]


@torch.no_grad()
def train_state_arrays(state) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` as the JAX ``TrainState``'s flat keys (see the
    module docstring), plus the generator's state under ``RNG_KEY``."""
    flat = {"step": np.asarray(state.step, np.int32)}
    for name, module in state.modules.items():
        scope = _scope(state, name)
        for key, a in flax_arrays(module).items():
            collection, rest = key.split(_SEP, 1)
            flat[_SEP.join((collection, *scope, rest))] = a
        opt = state.optimizers.get(name)
        if opt is None:
            continue
        inner = _adam(opt)
        prefix = _SEP.join(("opt_state", *scope, _adam_prefix(opt)))
        count = 0
        for p, key, conv in _param_keys(module):
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


def _scope(state, name: str) -> Tuple[str, ...]:
    """The key parts that place module ``name`` in the JAX TrainState: its
    name, or none for a state whose one module is ``ROOT_MODULE`` (the
    JAX TrainState of one model keeps its tree at the root)."""
    return () if list(state.modules) == [ROOT_MODULE] else (name,)


def _find_adam_prefix(flat, scope: Tuple[str, ...]) -> str:
    head = _SEP.join(("opt_state", *scope)) + _SEP
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
        scope = _scope(state, name)
        head = "".join(part + _SEP for part in scope)
        own = {}
        for key, value in flat.items():
            collection, _, rest = key.partition(_SEP)
            if collection in ("params", "batch_stats") and rest.startswith(
                    head):
                own[_SEP.join((collection, rest[len(head):]))] = value
        load_flax_params(module, own)
        opt = state.optimizers.get(name)
        if opt is None:
            continue
        inner = _adam(opt)
        prefix = _find_adam_prefix(flat, scope)
        count = int(flat[_SEP.join((prefix, "count"))])
        params = dict(module.named_parameters())
        keys = [key for _, key, _ in _param_keys(module)]
        moments = [_assemble(module, {
            _SEP.join(("params", key)): flat[_SEP.join((prefix, moment,
                                                        key))]
            for key in keys}, params) for moment in ("mu", "nu")]
        for name, p in params.items():
            inner.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": moments[0][name].to(p.device,
                                                             p.dtype),
                              "exp_avg_sq": moments[1][name].to(p.device,
                                                                p.dtype)}
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
