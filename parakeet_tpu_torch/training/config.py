"""Configuration (counterpart of ``parakeet_tpu/training/config.py``).

YAML -> attribute-accessible nested dict, ``--opts KEY VALUE`` dotted
overrides, freeze and a reproducibility dump, as the reference's yacs
usage (reference: parakeet/training/default_config.py:16-22,
training/cli.py:36-48).  ``yaml`` is imported inside the functions that
read or write YAML, so the rest of the port imports without PyYAML.

``resolve_model_kwargs`` lets the repository's YAML run unchanged: it maps
the JAX package's impl names and dtypes onto the port's and refuses what
the port lacks rather than dropping it.
"""
from __future__ import annotations

import io
from typing import List, Optional

__all__ = ["Config", "default_training_config", "inference_model_kwargs",
           "resolve_model_kwargs"]


class Config(dict):
    """Nested dict with attribute access and an optional frozen state."""

    def __init__(self, data: Optional[dict] = None, **kwargs):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        merged = dict(data or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return [cls._wrap(v) for v in value]
        return value

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, key, value):
        if getattr(self, "_frozen", False):
            raise AttributeError(f"config is frozen; cannot set {key!r}")
        super().__setitem__(key, self._wrap(value))

    # -- lifecycle ----------------------------------------------------------
    def freeze(self) -> "Config":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x
                          for x in v]
            else:
                out[k] = v
        return out

    # -- yaml / overrides ---------------------------------------------------
    @classmethod
    def from_yaml(cls, path) -> "Config":
        import yaml
        with open(path) as f:
            return cls(yaml.safe_load(f) or {})

    def merge(self, other: dict) -> "Config":
        for k, v in other.items():
            if (k in self and isinstance(self[k], Config)
                    and isinstance(v, dict)):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def merge_opts(self, opts: List[str]) -> "Config":
        """Apply ``["a.b", "1", "c", "hello", ...]`` dotted overrides, each
        value parsed as YAML."""
        import yaml
        if len(opts) % 2 != 0:
            raise ValueError("opts must be KEY VALUE pairs")
        for key, raw in zip(opts[::2], opts[1::2]):
            value = yaml.safe_load(raw)
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value
        return self

    def dump(self, path=None) -> str:
        import yaml
        text = yaml.safe_dump(self.to_dict(), sort_keys=False)
        if path is not None:
            with io.open(path, "w") as f:
                f.write(text)
        return text


# the JAX package's impl names -> the port's ('pallas' is the hand-written
# kernel there, 'fused' here; 'xla' the plain layer loop, 'eager' here)
_IMPL_NAMES = {"pallas": "fused", "xla": "eager", "auto": "auto",
               "fused": "fused", "eager": "eager"}
_FLOAT32_NAMES = ("float32", "fp32")
_BFLOAT16_NAMES = ("bfloat16", "bf16")


def default_training_config() -> Config:
    """The reference's defaults (training/default_config.py:16-22)."""
    return Config({
        "valid_interval": 1000,
        "save_interval": 10000,
        "max_iteration": 900000,
    })


def resolve_model_kwargs(cfg: dict) -> dict:
    """Model-section kwargs ready for the port's ``Model(**kwargs)``.

    ``stack_impl`` and ``impl`` take the JAX names ('pallas', 'xla',
    'auto') or the port's ('fused', 'eager', 'auto').  ``dtype`` naming
    float32 is dropped (the modules compute in their parameters' dtype);
    'bfloat16' becomes ``torch.bfloat16``, flax's ``dtype=``: mixed
    precision on float32 parameters, which every family takes.  Any other
    dtype raises ``NotImplementedError``.
    """
    kwargs = dict(cfg)
    for key in ("stack_impl", "impl"):
        if key in kwargs:
            name = str(kwargs[key]).lower()
            if name not in _IMPL_NAMES:
                raise ValueError(f"unknown {key} {kwargs[key]!r}; one of "
                                 f"{sorted(_IMPL_NAMES)}")
            kwargs[key] = _IMPL_NAMES[name]
    if "dtype" in kwargs:
        name = str(kwargs.pop("dtype")).lower()
        if name in _BFLOAT16_NAMES:
            import torch
            kwargs["dtype"] = torch.bfloat16
        elif name not in _FLOAT32_NAMES:
            raise NotImplementedError(
                f"model dtype {name!r}: the port's models take float32 or "
                "bfloat16")
    return kwargs


def inference_model_kwargs(cfg: dict) -> dict:
    """Model-section kwargs with training-only keys stripped: ``init_type``
    configures the train-time initialization (the reference consumes it
    before model construction, fastspeech2.py:114) and is no constructor
    field."""
    kwargs = resolve_model_kwargs(cfg)
    kwargs.pop("init_type", None)
    return kwargs
