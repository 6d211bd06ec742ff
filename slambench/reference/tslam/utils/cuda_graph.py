"""The eager half of the port's ``utils/cuda_graph.py``: ``device_cond``
reads its predicate and runs one branch, ``device_loop`` is a Python
loop.  This frozen copy captures no graph, so the capture's names are kept
only for the modules that import them, and building a graph raises."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch

CAPTURE_LOCK = threading.RLock()


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tuples, lists, dicts (by sorted key) and
    dataclasses, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tree_leaves(item)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    raise TypeError(f"a tree holds a {type(tree).__name__}, not tensors")


def device_cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
                operands: tuple = (), names: tuple = (None, None)):
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def device_loop(iters: int, step: Callable, carry):
    ys = []
    for _ in range(iters):
        carry, y = step(carry)
        ys.append(y)
    return carry, torch.stack(ys)


def add_launches(launches) -> None:
    pass


@contextlib.contextmanager
def counters_kept():
    yield


def _no_graph(*args, **kwargs):
    raise RuntimeError("the frozen reference runs eagerly: pass graph=False")


capture = warm_checked = _no_graph
