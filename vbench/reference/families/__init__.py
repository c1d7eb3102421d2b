"""The model families of the benchmark, one file each, found by name.

A configuration's ``family`` names the module ``families/<family>.py``
of this package, which gives everything the benchmark knows of that
family and nothing else holds:

- ``hidden(c, w, tokens, prec)``: the block math, tokens (B, T) to the
  final-normed hidden states (B, T, d), from the shared pieces of
  ``vbench.reference.model``, each weight upcast to float32 where it is
  used, a layer's slice (an expert's, where a layer holds experts) at a
  time;
- ``matmul_params(c)`` and ``attention_layers(c)``: the model FLOPs of a
  token, the matrix parameters it touches (of an MoE layer only its
  routed top-k and shared experts; the head, not the embedding's gather)
  and how many layers attend (``vbench.costs`` reads both);
- ``ONES`` and ``ZEROS``: leaf names, beyond ``vbench.weights``' own,
  that are set to ones (norm scales) or zeros (biases);
- ``TINY``: the family's cut for the CPU tests (``vbench.testing``), a
  width of 128 and two layers, or one period of a periodic family at
  tiny widths;
- ``PROGRAM_FAMILY`` and ``arch_fields(c)``: the ``family`` of the
  port's ``ArchConfig`` the configuration's ``arch`` must have, and that
  config's fields as a plain dict (a nested config as a dict of its own
  fields), which ``vbench.drivers.train.arch_config`` applies.

A family file imports nothing of the port and nothing of JAX.  A new
family is a new file here and its ``configs/<config>.json``.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType


def load(name: str) -> ModuleType:
    """The module of family ``name``; a missing file fails with its path."""
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as err:
        if err.name != module:
            raise
        raise SystemExit(f"vbench: no family {name!r}: "
                         f"{Path(__file__).parent / f'{name}.py'} "
                         "does not exist") from None


def of(c: dict) -> ModuleType:
    """The family module of configuration ``c`` (its ``family``)."""
    return load(c["family"])
