"""Epoch-versioned routing table — the cluster's slot-ownership plane.

Slot ownership used to live in a mutable list on ``LcapCluster``; every
layer read it in place and nothing could tell *when* it had changed.
``RoutingTable`` makes ownership a first-class immutable snapshot:

- ``slot_owner[s]`` is the shard that owns routing slot ``s`` (the FID
  hash ring of ``fid_slot``); per-target ``cr_prev`` chains never split
  across shards because a target's slot has exactly one owner per epoch.
- ``epoch`` increments on **every** topology change — drain start,
  migration commit/cancel, forced failover reassignment.  The epoch is
  piggybacked on the wire (offer/subscribe/fetch replies, ``caps`` and
  ``topology`` verbs) so consumers detect topology changes from any
  reply instead of assuming a fixed shard set.
- ``draining`` marks slots that are mid-migration (slot → destination
  shard).  A draining slot is still *owned* by its old shard — records
  already offered there keep flowing to consumers — but the coordinator
  parks newly read records for it until the old owner's watermark shows
  the slot's in-flight share fully acknowledged.

The epoch invariant every layer relies on: **within one epoch the
owner of a slot never changes**, and a bump is published before any
record is offered under the new assignment.  A consumer that has seen
epoch ``e`` can therefore cache its shard fan-in until it observes
``e' > e``, then re-resolve once.

Tables are cheap value objects: mutation helpers (:meth:`drain`,
:meth:`commit_drain`, :meth:`cancel_drain`, :meth:`reassign`) return a
new snapshot at ``epoch + 1`` and never touch the receiver, so readers
on other threads keep a coherent view without locking.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

__all__ = ["RoutingTable"]


class RoutingTable:
    """One immutable snapshot of slot → shard ownership at an epoch."""

    __slots__ = ("epoch", "slot_owner", "draining", "_owner_arr",
                 "_drain_arr")

    def __init__(self, epoch: int, slot_owner: Iterable[int],
                 draining: Mapping[int, int] = ()):
        object.__setattr__(self, "epoch", int(epoch))
        object.__setattr__(self, "slot_owner", tuple(slot_owner))
        object.__setattr__(self, "draining", dict(draining))
        object.__setattr__(self, "_owner_arr", None)
        object.__setattr__(self, "_drain_arr", None)

    def __setattr__(self, name, value):          # immutability guard
        raise AttributeError("RoutingTable is immutable; use drain()/"
                             "commit_drain()/reassign() to derive a new "
                             "epoch")

    # ---------------------------------------------------------- constructors
    @classmethod
    def initial(cls, n_slots: int, n_shards: int) -> "RoutingTable":
        """Epoch 0: slots striped round-robin across the shards."""
        return cls(0, (i % n_shards for i in range(n_slots)))

    # -------------------------------------------------------------- queries
    @property
    def n_slots(self) -> int:
        return len(self.slot_owner)

    def owner_array(self) -> np.ndarray:
        """``slot_owner`` as an int64 array, cached — the table is
        immutable, so the vectorized routing paths (``_partition``,
        ``ClusterReplayReader``) index it without re-materializing."""
        arr = self._owner_arr
        if arr is None:
            arr = np.asarray(self.slot_owner, dtype=np.int64)
            arr.setflags(write=False)
            object.__setattr__(self, "_owner_arr", arr)
        return arr

    def draining_mask(self) -> np.ndarray:
        """Boolean per slot: True while the slot is mid-migration."""
        arr = self._drain_arr
        if arr is None:
            arr = np.zeros(len(self.slot_owner), dtype=bool)
            if self.draining:
                arr[list(self.draining)] = True
            arr.setflags(write=False)
            object.__setattr__(self, "_drain_arr", arr)
        return arr

    def slots_of(self, shard: int) -> Tuple[int, ...]:
        """The slots shard ``shard`` currently owns."""
        return tuple(s for s, o in enumerate(self.slot_owner) if o == shard)

    def counts(self, n_shards: int) -> List[int]:
        """Slots owned per shard (for balance decisions and gauges)."""
        owned = [0] * n_shards
        for o in self.slot_owner:
            owned[o] += 1
        return owned

    def describe(self) -> Dict:
        """Wire-friendly summary for ``topology`` replies and debugging."""
        return {"epoch": self.epoch, "n_slots": len(self.slot_owner),
                "draining": len(self.draining)}

    # ------------------------------------------------------------ evolution
    def bumped(self) -> "RoutingTable":
        """Epoch+1 with ownership and draining unchanged — announces a
        topology event that moved no slots (e.g. a shard joined with
        zero slots) so consumers re-resolve the shard set."""
        return RoutingTable(self.epoch + 1, self.slot_owner, self.draining)

    def drain(self, slots: Iterable[int], target: int) -> "RoutingTable":
        """Epoch+1 with ``slots`` marked draining toward ``target``.
        Ownership is unchanged — the old owner keeps serving what it
        already ingested while new offers for these slots park."""
        draining = dict(self.draining)
        for s in slots:
            draining[int(s)] = int(target)
        return RoutingTable(self.epoch + 1, self.slot_owner, draining)

    def commit_drain(self) -> "RoutingTable":
        """Epoch+1 with every draining slot handed to its destination
        and the draining set cleared — the migration commit point."""
        owner = list(self.slot_owner)
        for s, tgt in self.draining.items():
            owner[s] = tgt
        return RoutingTable(self.epoch + 1, owner)

    def cancel_drain(self) -> "RoutingTable":
        """Epoch+1 with the draining set cleared and ownership
        unchanged (migration aborted, e.g. its target died)."""
        return RoutingTable(self.epoch + 1, self.slot_owner)

    def reassign(self, mapping: Mapping[int, int]) -> "RoutingTable":
        """Epoch+1 with ``mapping`` (slot → new owner) applied directly
        — the forced path (failover), which cannot wait for a drain.
        Any draining marks on the reassigned slots are dropped."""
        owner = list(self.slot_owner)
        draining = dict(self.draining)
        for s, o in mapping.items():
            owner[int(s)] = int(o)
            draining.pop(int(s), None)
        return RoutingTable(self.epoch + 1, owner, draining)

    def __repr__(self) -> str:                   # pragma: no cover
        return (f"RoutingTable(epoch={self.epoch}, "
                f"n_slots={len(self.slot_owner)}, "
                f"draining={len(self.draining)})")
