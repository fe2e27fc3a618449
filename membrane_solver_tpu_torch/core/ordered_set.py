"""Insertion-ordered unique list used for module name collections.

Copy of ``membrane_solver_tpu/core/ordered_set.py`` (NumPy host code); only the
import paths differ.

Parity: reference ``core/ordered_unique_list.py``.
"""

from __future__ import annotations

from typing import Iterable, Iterator


class OrderedUniqueList(list):
    """A list that silently drops duplicate insertions, preserving order."""

    def __init__(self, iterable: Iterable = ()):  # noqa: D107
        super().__init__()
        for item in iterable:
            self.append(item)

    def append(self, item) -> None:
        if item not in self:
            super().append(item)

    def extend(self, iterable: Iterable) -> None:
        for item in iterable:
            self.append(item)

    def add(self, item) -> None:
        self.append(item)

    def __iadd__(self, iterable: Iterable) -> "OrderedUniqueList":
        self.extend(iterable)
        return self

    def copy(self) -> "OrderedUniqueList":
        return OrderedUniqueList(self)

    def __iter__(self) -> Iterator:
        return super().__iter__()
