"""Engine-slot allocation: controllers -> voice slots.

Generalizes the reference's multi-controller placement logic (the closest
thing it has to a scheduler — reference:
server-multi-for-2-controllers_OLD.py:468-495, 642-698): a stable
device-id -> slot mapping is honored first, then first-free-slot assignment,
with occupancy conflict detection; detach frees the slot.
"""

from __future__ import annotations

__all__ = ["SlotAllocator"]


class SlotAllocator:
    def __init__(self, slots: list[str], pinned: dict[str, str] | None = None) -> None:
        """slots: ordered slot names (e.g. ["A", "B"] or 64 stream ids).
        pinned: device_id -> slot preferences (the reference's
        DEVICE_ID_TO_ENGINE stable mapping)."""
        self.slots = list(slots)
        self.pinned = dict(pinned or {})
        self.occupancy: dict[str, str] = {}  # slot -> device_id

    def assign(self, device_id: str) -> str | None:
        """Pick a slot for a controller; None when full or conflicted."""
        # already assigned? (idempotent re-probe)
        for slot, dev in self.occupancy.items():
            if dev == device_id:
                return slot
        want = self.pinned.get(device_id)
        if want is not None:
            if want not in self.slots:
                return None
            if want in self.occupancy:  # conflict: pinned slot already taken
                return None
            self.occupancy[want] = device_id
            return want
        for slot in self.slots:
            if slot not in self.occupancy:
                self.occupancy[slot] = device_id
                return slot
        return None

    def release(self, device_id: str) -> str | None:
        for slot, dev in list(self.occupancy.items()):
            if dev == device_id:
                del self.occupancy[slot]
                return slot
        return None

    def slot_of(self, device_id: str) -> str | None:
        for slot, dev in self.occupancy.items():
            if dev == device_id:
                return slot
        return None

    def free_slots(self) -> list[str]:
        return [s for s in self.slots if s not in self.occupancy]
