"""Shared-memory page-frame arena — the zero-copy data plane under the
multi-process cluster backend (``runtime/node_proc.py``).

Control messages between the driver and the per-node processes travel over a
length-prefixed socket (``runtime/rpc.py``); page payloads do NOT.  Each node
gets two arenas carved out of ``multiprocessing.shared_memory`` segments:

* an **inbox** the driver writes into (set creation / replica bytes), and
* an **outbox** the node process writes into (shuffle partition page images,
  set exports) that the driver *and sibling node processes* map read-only.

An arena is a single segment sliced into fixed-size frames.  Exactly one
process — the *allocator* — hands frames out and takes them back; every other
process only maps the segment and reads the frames named by a descriptor it
received over the control plane.  Descriptors are plain dicts (frame index
list + byte count), so they ride the JSON envelope with zero pickling.

Creation and unlinking are likewise owned by exactly one process (the
driver), regardless of who allocates: a SIGKILLed node process can never
leak a segment, because it never owned one.  ``segment_exists`` supports the
leak check the cluster runs on close.

Copy of the JAX package's ``core/shm_arena.py``; nothing changes.
"""
from __future__ import annotations

import secrets
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, Iterable, List, Optional

import numpy as np

from .sanitizer import tracked_lock


class ArenaFullError(RuntimeError):
    """No run of free frames can hold the payload right now."""


def arena_name(tag: str) -> str:
    """A segment name unique across concurrent test runs on one host."""
    return f"pgea-{tag}-{secrets.token_hex(4)}"


def segment_exists(name: str) -> bool:
    """Whether a shared-memory segment of this name still exists (leak
    probe: attach read-only and immediately detach)."""
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    # CPython < 3.13 registers even plain attaches with the resource
    # tracker, which would unlink the segment when *this* process exits.
    _untrack(seg)
    seg.close()
    return True


def _untrack(seg: shared_memory.SharedMemory) -> None:
    try:  # pragma: no cover - defensive; name mangling differs per version
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass


class ShmArena:
    """Fixed-frame allocator over one shared-memory segment.

    ``create=True`` makes (and later unlinks) the segment; ``owner=True``
    runs the frame allocator.  The two are independent so the driver can
    create a node's outbox while the node process allocates from it.
    """

    def __init__(self, name: str, frame_size: int, num_frames: int,
                 *, create: bool = False, owner: bool = False):
        if frame_size <= 0 or num_frames <= 0:
            raise ValueError("arena needs positive frame_size and num_frames")
        self.name = name
        self.frame_size = int(frame_size)
        self.num_frames = int(num_frames)
        self.capacity = self.frame_size * self.num_frames
        self.owner = bool(owner)
        self.created = bool(create)
        self._seg = shared_memory.SharedMemory(
            name=name, create=create, size=self.capacity if create else 0)
        # CPython < 3.13 registers BOTH creates and attaches with the
        # resource tracker.  Forked node processes share the driver's
        # tracker, so any tracked registration would be double-counted
        # (noisy KeyErrors, premature unlinks).  Lifetime is managed
        # explicitly by the creator instead: untrack here, re-register
        # just before ``unlink`` so its internal unregister balances.
        _untrack(self._seg)
        self._buf = np.frombuffer(self._seg.buf, dtype=np.uint8,
                                  count=self.capacity)
        self._free: List[int] = list(range(self.num_frames)) if owner else []
        # allocator ops can come from concurrent driver threads (the
        # transfer engine ships shards in parallel)
        self._alloc_lock = tracked_lock("shm_arena")
        # Observability: the leak check wants in-use == 0 at close, the
        # benchmark wants peak occupancy.
        self.frames_in_use = 0
        self.peak_frames = 0
        self.puts = 0
        self.bytes_put = 0
        self._closed = False

    @classmethod
    def attach(cls, name: str, frame_size: int, num_frames: int,
               *, owner: bool = False) -> "ShmArena":
        """Map a segment some other process created.  ``owner=True`` means
        this process runs the allocator (a node process owning its outbox)."""
        return cls(name, frame_size, num_frames, create=False, owner=owner)

    # -- allocator side ----------------------------------------------------
    def put(self, payload) -> Dict[str, object]:
        """Copy ``payload`` (any buffer) into free frames; returns the
        JSON-able descriptor naming them.  Raises ArenaFullError when the
        payload cannot fit in the currently free frames."""
        if not self.owner:
            raise RuntimeError("only the arena owner can allocate frames")
        raw = np.frombuffer(payload, dtype=np.uint8)
        nbytes = raw.nbytes
        need = max(1, -(-nbytes // self.frame_size))
        with self._alloc_lock:
            if need > len(self._free):
                raise ArenaFullError(
                    f"arena {self.name}: need {need} frames, "
                    f"{len(self._free)} free")
            frames = [self._free.pop() for _ in range(need)]
            self.frames_in_use += need
            self.peak_frames = max(self.peak_frames, self.frames_in_use)
            self.puts += 1
            self.bytes_put += nbytes
        off = 0
        for f in frames:
            n = min(self.frame_size, nbytes - off)
            base = f * self.frame_size
            self._buf[base:base + n] = raw[off:off + n]
            off += n
        return {"frames": frames, "nbytes": nbytes}

    def free(self, desc: Dict[str, object]) -> None:
        if not self.owner:
            raise RuntimeError("only the arena owner can free frames")
        frames = list(desc["frames"])
        with self._alloc_lock:
            self._free.extend(frames)
            self.frames_in_use -= len(frames)

    def free_frames(self) -> int:
        with self._alloc_lock:
            return len(self._free)

    def reset_counters(self) -> None:
        """Zero the observability counters (``puts``/``bytes_put``/
        ``peak_frames``) so tests can assert per-test deltas on a shared
        arena; ``frames_in_use`` is live accounting and is left alone."""
        with self._alloc_lock:
            self.puts = 0
            self.bytes_put = 0
            self.peak_frames = self.frames_in_use

    # -- reader side (works for the owner too) -----------------------------
    def read(self, desc: Dict[str, object]) -> np.ndarray:
        """Gather a descriptor's bytes into one contiguous array (the single
        copy a cross-process page move pays on the read side)."""
        nbytes = int(desc["nbytes"])
        out = np.empty(nbytes, dtype=np.uint8)
        off = 0
        for f in desc["frames"]:
            n = min(self.frame_size, nbytes - off)
            base = int(f) * self.frame_size
            out[off:off + n] = self._buf[base:base + n]
            off += n
        return out

    def read_into(self, desc: Dict[str, object], out: np.ndarray) -> int:
        """Gather directly into ``out`` (e.g. a pinned pool page view)."""
        nbytes = int(desc["nbytes"])
        off = 0
        for f in desc["frames"]:
            n = min(self.frame_size, nbytes - off)
            base = int(f) * self.frame_size
            out[off:off + n] = self._buf[base:base + n]
            off += n
        return nbytes

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Detach this process's mapping (never destroys the segment)."""
        if self._closed:
            return
        self._closed = True
        self._buf = None
        try:
            self._seg.close()
        except Exception:  # pragma: no cover
            pass

    def __del__(self) -> None:  # pragma: no cover - GC-order safety net
        # Drop the numpy view BEFORE the segment's own __del__ runs, else
        # an abandoned arena dies with "cannot close exported pointers".
        try:
            self.close()
        except Exception:
            pass

    def unlink(self) -> None:
        """Destroy the segment.  Only the creating process calls this."""
        if not self.created:
            raise RuntimeError("only the arena creator can unlink it")
        self.close()
        try:
            resource_tracker.register(self._seg._name, "shared_memory")
        except Exception:  # pragma: no cover
            pass
        try:
            self._seg.unlink()
        except FileNotFoundError:  # pragma: no cover
            pass


def gather(arena: Optional[ShmArena], desc: Optional[Dict[str, object]],
           raw: bytes) -> np.ndarray:
    """Uniform read side of the two payload channels: a shm descriptor when
    the arena had room, else the raw socket bytes that rode the envelope."""
    if desc is not None:
        if arena is None:
            raise RuntimeError("descriptor received but no arena attached")
        return arena.read(desc)
    return np.frombuffer(bytearray(raw), dtype=np.uint8)
