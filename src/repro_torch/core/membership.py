"""Shared membership verbs for replicated member sets.

``ReplicaSet`` (read-write snapshot replicas) and the edge-cache tier
(``core/edge.py``, read-only capsule caches) both manage a list of
members with liveness state that the churn simulator kills, revives,
permanently removes and promotes.  Before this mixin each class carried
its own copy of those verbs with slightly different index bookkeeping;
now one implementation owns the list/liveness invariants (index remap on
``remove``, down-member promotion refusal, primary protection) and the
per-class behaviour — parked outbox refs, cache invalidation, telemetry
events — hangs off the ``_on_*`` hooks.  ``ChurnSim`` drives every
member set through this one interface.
"""
from __future__ import annotations

from typing import Iterable, List


class Membership:
    """Liveness + membership verbs over ``self.members``.

    Subclass contract: call ``_init_membership(members)`` during
    ``__init__`` and override the ``_on_down`` / ``_on_up`` /
    ``_on_remove`` / ``_on_promote`` hooks for class-specific
    bookkeeping.  ``primary_index`` is the distinguished member — the
    write target for a ``ReplicaSet``, the preferred ranking tie-break
    for the edge tier; ``promote`` moves it and ``remove`` refuses to
    drop it (promote a survivor first).
    """

    def _init_membership(self, members: Iterable,
                         primary_index: int = 0) -> None:
        self.members: List = list(members)
        self.primary_index = primary_index
        self._down: set[int] = set()

    # -- hooks (default: no-op) --------------------------------------------
    def _on_down(self, index: int) -> None:
        pass

    def _on_up(self, index: int) -> None:
        pass

    def _on_remove(self, index: int) -> None:
        """Called after the member left and ``_down``/``primary_index``
        were remapped; ``index`` is the member's *pre-removal* slot."""

    def _on_promote(self, index: int) -> None:
        pass

    # -- queries -----------------------------------------------------------
    def is_down(self, index: int) -> bool:
        return index in self._down

    def alive_indices(self) -> List[int]:
        return [i for i in range(len(self.members)) if i not in self._down]

    def _check_index(self, index: int) -> None:
        if not 0 <= index < len(self.members):
            raise IndexError(f"no member {index}")

    # -- verbs -------------------------------------------------------------
    def mark_down(self, index: int) -> None:
        """Mark a member unreachable (it stays in the set and may revive)."""
        self._check_index(index)
        self._down.add(index)
        self._on_down(index)

    def mark_up(self, index: int) -> None:
        """Bring a member back into rotation."""
        self._check_index(index)
        self._down.discard(index)
        self._on_up(index)

    def remove(self, index: int) -> None:
        """Permanently drop a member (a host that will never return).
        The primary cannot be removed — promote a survivor first."""
        self._check_index(index)
        if index == self.primary_index:
            raise ValueError("cannot remove the primary; promote first")
        del self.members[index]
        self._down = {i - (i > index) for i in self._down if i != index}
        if self.primary_index > index:
            self.primary_index -= 1
        self._on_remove(index)

    def promote(self, index: int) -> None:
        """Redesignate an alive member as the distinguished one
        (failover for a replica set, preferred cache for the edge tier)."""
        self._check_index(index)
        if index in self._down:
            raise ValueError(f"cannot promote member {index}: marked down")
        if index != self.primary_index:
            self.primary_index = index
            self._on_promote(index)
