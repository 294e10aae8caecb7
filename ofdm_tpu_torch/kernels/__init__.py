"""The port's hand-written kernels, one public module per source family,
each wrapper beside its plain version; ``counters`` lists them."""

from __future__ import annotations

import importlib
import inspect
import pkgutil


def counters() -> dict:
    """``{name: wrapper}`` of every hand kernel: each function of a public
    module of this package that carries an int ``launches`` (the count of
    its CUDA launches).  Imports those modules; a new kernel is found with
    no edit here, and two counted functions of one name raise."""
    found = {}
    for info in pkgutil.iter_modules(__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod.__name__ \
                    or type(getattr(fn, "launches", None)) is not int:
                continue
            if name in found:
                raise RuntimeError(f"two launch counters named {name!r}")
            found[name] = fn
    return found
