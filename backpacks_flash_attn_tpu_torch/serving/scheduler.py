"""Request scheduler: the C++ control plane (``csrc/scheduler.cpp``) through
ctypes, and its pure-Python twin with identical semantics.

Port of ``backpacks_flash_attn_tpu/serving/scheduler.py``. The C++ library
is compiled with ``g++`` at first use into ``build/scheduler/`` at the root
of the checkout (a directory ``.gitignore`` lists), keyed by the source's
content hash. ``make_scheduler(prefer_native=True)`` raises with the
compiler's log when that build fails, instead of taking the twin silently.
"""

from __future__ import annotations

import ctypes
from collections import deque
from pathlib import Path
from typing import List, Optional, Tuple

from ..ops import _build

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "scheduler.cpp"

_LIB: Optional[ctypes.CDLL] = None


def build_native() -> Path:
    """Compile scheduler.cpp (once per content hash); returns the library
    path, or raises RuntimeError with the compiler's output."""
    return _build.build_host_library(_SRC, "scheduler", "libbpsched")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_native()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        sigs = {
            "bpsched_new": (vp, [i32, i32, i32]),
            "bpsched_free": (None, [vp]),
            "bpsched_submit": (i32, [vp, i64, i32, i32]),
            "bpsched_admit": (i32, [vp, ctypes.POINTER(i64),
                                    ctypes.POINTER(i32)]),
            "bpsched_num_pending": (i32, [vp]),
            "bpsched_num_active": (i32, [vp]),
            "bpsched_completed": (i64, [vp]),
            "bpsched_on_token": (i32, [vp, i32, i32]),
            "bpsched_slot_request": (i64, [vp, i32]),
            "bpsched_slot_num_tokens": (i32, [vp, i32]),
            "bpsched_slot_tokens": (i32, [vp, i32, ctypes.POINTER(i32), i32]),
            "bpsched_slot_active": (i32, [vp, i32]),
            "bpsched_release": (None, [vp, i32]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the C++ scheduler builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeScheduler:
    """ctypes facade over csrc/scheduler.cpp."""

    def __init__(self, max_slots: int, max_seqlen: int, eos_id: int):
        self._lib = _lib()
        self._h = self._lib.bpsched_new(max_slots, max_seqlen, eos_id)
        self.max_slots = max_slots

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bpsched_free(self._h)
            self._h = None

    def submit(self, request_id: int, prompt_len: int,
               max_new_tokens: int) -> bool:
        return self._lib.bpsched_submit(self._h, request_id, prompt_len,
                                        max_new_tokens) == 0

    def admit(self) -> Optional[Tuple[int, int, int]]:
        rid, plen = ctypes.c_int64(), ctypes.c_int32()
        slot = self._lib.bpsched_admit(self._h, ctypes.byref(rid),
                                       ctypes.byref(plen))
        if slot < 0:
            return None
        return slot, rid.value, plen.value

    def on_token(self, slot: int, token: int) -> bool:
        r = self._lib.bpsched_on_token(self._h, slot, token)
        if r < 0:
            raise ValueError(f"bad/inactive slot {slot}")
        return bool(r)

    def slot_request(self, slot: int) -> int:
        return self._lib.bpsched_slot_request(self._h, slot)

    def slot_tokens(self, slot: int) -> List[int]:
        n = self._lib.bpsched_slot_num_tokens(self._h, slot)
        buf = (ctypes.c_int32 * max(n, 1))()
        got = self._lib.bpsched_slot_tokens(self._h, slot, buf, n)
        return list(buf[:got])

    def slot_active(self, slot: int) -> bool:
        return self._lib.bpsched_slot_active(self._h, slot) == 1

    def release(self, slot: int) -> None:
        self._lib.bpsched_release(self._h, slot)

    @property
    def num_pending(self) -> int:
        return self._lib.bpsched_num_pending(self._h)

    @property
    def num_active(self) -> int:
        return self._lib.bpsched_num_active(self._h)

    @property
    def completed(self) -> int:
        return self._lib.bpsched_completed(self._h)


class PyScheduler:
    """Pure-Python twin with identical semantics: the conformance oracle of
    the C++ scheduler, and the scheduler when ``prefer_native=False``."""

    def __init__(self, max_slots: int, max_seqlen: int, eos_id: int):
        self.max_slots = max_slots
        self.max_seqlen = max_seqlen
        self.eos_id = eos_id
        self._pending = deque()
        self._slots = [{"request_id": -1, "prompt_len": 0,
                        "max_new_tokens": 0, "tokens": [], "active": False}
                       for _ in range(max_slots)]
        # LIFO, lowest slot first: the C++ free-list order
        self._free = list(range(max_slots - 1, -1, -1))
        self.completed = 0

    def submit(self, request_id, prompt_len, max_new_tokens) -> bool:
        if prompt_len <= 0 or prompt_len + 1 > self.max_seqlen:
            return False
        self._pending.append((request_id, prompt_len, max_new_tokens))
        return True

    def admit(self):
        if not self._pending or not self._free:
            return None
        slot = self._free.pop()
        rid, plen, mnt = self._pending.popleft()
        self._slots[slot] = {"request_id": rid, "prompt_len": plen,
                             "max_new_tokens": mnt, "tokens": [],
                             "active": True}
        return slot, rid, plen

    def on_token(self, slot, token) -> bool:
        sl = self._slots[slot]
        if not sl["active"]:
            raise ValueError(f"bad/inactive slot {slot}")
        sl["tokens"].append(token)
        done = (token == self.eos_id
                or len(sl["tokens"]) >= sl["max_new_tokens"]
                or sl["prompt_len"] + len(sl["tokens"]) >= self.max_seqlen)
        if done:
            sl["active"] = False
            self.completed += 1
        return done

    def slot_request(self, slot):
        return self._slots[slot]["request_id"]

    def slot_tokens(self, slot):
        return list(self._slots[slot]["tokens"])

    def slot_active(self, slot):
        return self._slots[slot]["active"]

    def release(self, slot):
        sl = self._slots[slot]
        if sl["request_id"] == -1:
            return
        sl.update(request_id=-1, active=False, tokens=[])
        self._free.append(slot)

    @property
    def num_pending(self):
        return len(self._pending)

    @property
    def num_active(self):
        return sum(1 for s in self._slots if s["active"])


def make_scheduler(max_slots: int, max_seqlen: int, eos_id: int,
                   prefer_native: bool = True):
    """The C++ scheduler (its build raises on failure) or, with
    prefer_native=False, the Python twin."""
    if prefer_native:
        return NativeScheduler(max_slots, max_seqlen, eos_id)
    return PyScheduler(max_slots, max_seqlen, eos_id)
