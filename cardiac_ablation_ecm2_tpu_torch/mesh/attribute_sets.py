"""Named attribute sets.

Copy of ``cardiac_ablation_ecm2_tpu/mesh/attribute_sets.py``.

Reference analog: ``AttributeSets`` (``mesh/attribute_sets.cpp``) used by
ex39: name groups of element/boundary attributes and convert names to
marker lists.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union


class AttributeSets:
    """Named collections of attribute numbers (ex39 analog)."""

    def __init__(self):
        self._sets: Dict[str, set] = {}

    def set(self, name: str, attrs: Sequence[int]) -> None:
        self._sets[name] = set(int(a) for a in attrs)

    def add_to(self, name: str, attrs: Sequence[int]) -> None:
        self._sets.setdefault(name, set()).update(int(a) for a in attrs)

    def get(self, name: str) -> List[int]:
        return sorted(self._sets[name])

    def union(self, *names: str) -> List[int]:
        out = set()
        for n in names:
            out |= self._sets[n]
        return sorted(out)

    def __contains__(self, name: str) -> bool:
        return name in self._sets

    def names(self) -> List[str]:
        return sorted(self._sets)


def resolve_marker(marker: Union[None, str, Sequence], sets: AttributeSets):
    """Accept either a set name or an explicit attribute list."""
    if marker is None:
        return None
    if isinstance(marker, str):
        return sets.get(marker)
    return list(marker)
