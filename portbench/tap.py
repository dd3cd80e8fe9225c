"""Keeps copies of what chosen functions of the program return.

The comparison judges the program's own intermediate outputs (the
rectified pair, the SGM disparity) as well as its final ones. `Tap.wrap`
replaces a module attribute by a wrapper that calls the original and, while
the tap is armed, stores a detached copy of its result under a key. The
wrapper is installed in every run, armed only on the frames the seed
chose for the check, and removed by `restore`.
"""
from __future__ import annotations

import functools

import torch


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    return x


class Tap:
    def __init__(self):
        self.armed = False
        self.kept = {}
        self._undo = []

    def wrap(self, module, attr: str, key: str) -> None:
        orig = getattr(module, attr)

        @functools.wraps(orig)  # carries the function's attributes (launch counters)
        def tapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.armed:
                self.kept.setdefault(key, []).append(_copy(out))
            return out

        setattr(module, attr, tapped)
        self._undo.append((module, attr, orig))

    def take(self) -> dict:
        kept, self.kept = self.kept, {}
        return kept

    def restore(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()
