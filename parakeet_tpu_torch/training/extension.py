"""Extension protocol for the trainer (a copy of
``parakeet_tpu/training/extension.py``, which the port cannot import: that
package's ``__init__`` pulls in JAX).

Same contract as the reference (reference:
parakeet/training/extension.py:16-66): an extension is a callable invoked by
the trainer when its trigger fires, with a priority ordering and optional
initialize / on_error / finalize hooks.
"""
from __future__ import annotations

__all__ = ["PRIORITY_WRITER", "PRIORITY_EDITOR", "PRIORITY_READER",
           "Extension", "make_extension"]

PRIORITY_WRITER = 300   # produces observations (e.g. evaluators)
PRIORITY_EDITOR = 200   # modifies observations
PRIORITY_READER = 100   # consumes observations (loggers, writers)


class Extension:
    trigger = (1, "iteration")
    priority = PRIORITY_READER
    name: str = None

    @property
    def default_name(self) -> str:
        return type(self).__name__

    def __call__(self, trainer) -> None:
        raise NotImplementedError

    def initialize(self, trainer) -> None:
        pass

    def on_error(self, trainer, exc, tb) -> None:
        pass

    def finalize(self, trainer) -> None:
        pass


def make_extension(trigger=None, priority: int = PRIORITY_READER,
                   name: str = None, initializer=None, on_error=None,
                   finalizer=None):
    """Decorate a plain function into an extension."""
    def wrapper(fn):
        fn.trigger = trigger if trigger is not None else (1, "iteration")
        fn.priority = priority
        fn.name = name or getattr(fn, "__name__", "extension")
        fn.default_name = fn.name
        if initializer:
            fn.initialize = initializer
        if on_error:
            fn.on_error = on_error
        if finalizer:
            fn.finalize = finalizer
        return fn
    return wrapper
