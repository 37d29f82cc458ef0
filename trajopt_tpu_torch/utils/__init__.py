"""Utilities: configuration, cache, checkpoints, failed-QP dumps, finite
differences, joint subsets, logging and profiling."""

import weakref

import numpy as np
import torch


def to_numpy(v) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


_ON_DEVICE: dict = {}
_LITERALS: dict = {}


def on_device(owner, key, make, device, dtype=None) -> torch.Tensor:
    """``make()`` (host data of ``owner``: an index, a mask, a table) as a
    tensor on ``device`` in ``dtype`` (default its own), built once per
    (owner, key, device, dtype), kept while ``owner`` lives (it must take
    weak references) and dropped with it or by :func:`forget_on_device`.
    A captured region cannot copy from the host, so a region's constants
    are built here by its first, eager call.  The tensor is shared: do not
    write to it."""
    slot = _ON_DEVICE.get(id(owner))
    if slot is None:
        slot = _ON_DEVICE[id(owner)] = {}
        weakref.finalize(owner, _ON_DEVICE.pop, id(owner), None)
    k = (key, device, dtype)
    t = slot.get(k)
    if t is None:
        t = slot[k] = torch.as_tensor(np.array(make()), dtype=dtype,
                                      device=device)
    return t


def forget_on_device(owner) -> None:
    """Drop ``owner``'s :func:`on_device` tensors (its host data changed)."""
    slot = _ON_DEVICE.get(id(owner))
    if slot is not None:
        slot.clear()


def device_const(v: float, device, dtype) -> torch.Tensor:
    """The literal number ``v`` as a 0-d tensor on ``device`` in ``dtype``,
    built once (see :func:`on_device`); for operations that take tensors
    only (``torch.maximum``), where a literal must keep their gradient."""
    k = (float(v), device, dtype)
    t = _LITERALS.get(k)
    if t is None:
        t = _LITERALS[k] = torch.tensor(float(v), dtype=dtype,
                                        device=device)
    return t
