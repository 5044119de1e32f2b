"""Seeding of the port's random streams.

Counterpart of ``mxnet_tpu/random.py`` (reference ``mx.random.seed``).
:func:`seed` seeds two things, per thread as there: the package-owned
numpy ``RandomState`` that initializers and data shuffles draw from
(:func:`host_rng`, the very stream the JAX package's initializers draw
from, so that after the same seed both packages initialize bit for bit
alike), and one ``torch.Generator`` per device, which takes the place of
the JAX package's key chain for draws on the device (the RNN op's
inter-layer dropout). A generator gives other numbers than
``jax.random`` from the same seed. numpy's and torch's global streams are
not touched.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["seed", "host_rng", "generator"]

_state = threading.local()


def seed(seed_state: int):
    """Seed this package's host stream and its device generators."""
    _state.host_rng = _np.random.RandomState(int(seed_state) % (2 ** 32))
    _state.seed = int(seed_state) % (2 ** 63)
    _state.generators = {}


def host_rng() -> _np.random.RandomState:
    """The package-owned numpy RandomState for host-side draws
    (initializers, shuffles). Deterministic after :func:`seed`, seeded
    from OS entropy otherwise."""
    if not hasattr(_state, "host_rng"):
        _state.host_rng = _np.random.RandomState()
    return _state.host_rng


def generator(device) -> torch.Generator:
    """The ``torch.Generator`` of ``device`` for this thread: seeded by the
    last :func:`seed`, or from OS entropy before any."""
    device = torch.device(device)
    gens = getattr(_state, "generators", None)
    if gens is None:
        gens = _state.generators = {}
    gen = gens.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        if hasattr(_state, "seed"):
            gen.manual_seed(_state.seed)
        else:
            gen.seed()
        gens[device] = gen
    return gen
