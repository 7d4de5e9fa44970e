"""Async node-to-node transfer engine — the cluster's "network stack".

The first version moved every byte synchronously: ``Cluster.transfer_records`` streamed
pages inline, so reducer pulls serialized behind map finalization and behind
each other. This module extracts the two halves:

* ``copy_set`` — the mechanics: stream one locality set between two buffer
  pools page by page (paged reads on the source, sequential writes on the
  destination). ``Cluster.transfer_records`` is now one client of it.
* ``TransferEngine`` — the asynchrony: a small producer/consumer thread pool
  (BatchLoader-style) whose jobs may declare dependencies (``after=``), so a
  reducer pull can be submitted before the map side has finalized and the
  engine orders them. Workers exit after an idle timeout and are respawned on
  the next submit, so short-lived clusters in tests don't accumulate threads.

The engine also enforces **per-destination in-flight byte caps**
(the wire half of admission control): jobs may declare the node their bytes
land on (``dest=``) and how many (``nbytes=``), and the engine holds a job
back while that destination already has a cap's worth of transfer bytes in
flight — so overlapped reducer pulls can't stampede one reducer node even
before its MemoryManager starts refusing staging. ``dest``/``nbytes`` may be
callables, resolved once the job's dependencies finish (a pull submitted
before placement doesn't know its reducer node yet). A destination with
nothing in flight always admits one job, so an oversized transfer can't
starve.

The buffer pool is internally locked (pin/unpin/new_page take the pool's
RLock), which is what makes concurrent pulls through shared source pools safe.

Copy of the JAX package's ``runtime/transfer.py``; nothing changes.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.attributes import AttributeSet, StorageScheme
from ..core.sanitizer import note_blocking, tracked_condition, tracked_lock
from ..core.services import _HEADER, PageIterator, SequentialWriter


def copy_set(src_pool, src_set_name: str, dst_pool, dst_set_name: str,
             dtype: np.dtype, page_size: int,
             attrs: Optional[AttributeSet] = None) -> int:
    """Stream one locality set between pools page by page; returns bytes
    moved. This is the wire: a paged read on the source feeding a sequential
    write on the destination. Each in-flight chunk is charged to the
    destination's MemoryManager (``reserve``) so replica creation and
    recovery copies show up in the same pressure accounting as shuffle pulls
    and remesh streams.

    Row sets decode records per page (the destination re-packs them);
    columnar sets (and sources whose pages already are column blocks) take
    :func:`copy_set_raw` instead — page images move as raw buffers with no
    per-record decode/encode at either end."""
    src_ls = src_pool.get_set(src_set_name)
    if (src_ls.attrs.storage is StorageScheme.COLUMNAR
            or (attrs is not None
                and attrs.storage is StorageScheme.COLUMNAR)):
        return copy_set_raw(src_pool, src_set_name, dst_pool, dst_set_name,
                            np.dtype(dtype), attrs)
    dtype = np.dtype(dtype)
    ls_dst = dst_pool.create_set(dst_set_name, page_size, attrs)
    writer = SequentialWriter(dst_pool, ls_dst, dtype)
    memory = getattr(dst_pool, "memory", None)
    moved = 0
    for recs in PageIterator(src_pool, src_ls, dtype, sorted(src_ls.pages)):
        reservation = memory.reserve(recs.nbytes) if memory is not None else None
        try:
            writer.append_batch(recs)
        finally:
            if reservation is not None:
                reservation.release()
        moved += recs.nbytes
    writer.close()
    return moved


def iter_page_images(pool, ls):
    """Pin each page of a set in page-id order and yield ``(size, view)``.
    The view is a uint8 window over the pool's backing store, valid only
    until the next iteration — callers copy it out (into a destination page,
    a shm arena frame, or a socket buffer) before advancing.  This is the
    producer half of every raw page-image move: same-pool replica copies
    (:func:`copy_set_raw`) and the multi-process backend's shm exports share
    it, so neither path ever touches per-record decode or pickle."""
    for pid in sorted(ls.pages):
        page = ls.pages[pid]
        view = pool.pin(page)
        try:
            yield page.size, view
        finally:
            pool.unpin(page)


def land_page_image(pool, ls, image, memory=None) -> None:
    """The consumer half: allocate a destination page of the image's exact
    size and memcpy the image in (charged to ``memory`` while in flight).
    Valid for any self-describing page — row small-page blocks and columnar
    blocks alike carry their own count headers."""
    image = np.frombuffer(image, dtype=np.uint8)
    reservation = memory.reserve(image.nbytes) if memory is not None else None
    try:
        dst_page = pool.new_page(ls, size=image.nbytes)
        pool.view(dst_page)[:] = image
        pool.unpin(dst_page, dirty=True)
    finally:
        if reservation is not None:
            reservation.release()


def copy_set_raw(src_pool, src_set_name: str, dst_pool, dst_set_name: str,
                 dtype: np.dtype, attrs: Optional[AttributeSet] = None) -> int:
    """Move a set between pools as raw page images: pin source page, alloc an
    equally sized destination page, one memcpy, unpin dirty. No per-record
    pickling or decode — the columnar fast wire (a column block is
    position-dependent inside its page, so the image must move whole; the
    destination set inherits the source's page size for the same reason).
    Returns the *logical* record bytes moved (each block's ``count`` header
    times the record width) so net-byte accounting stays comparable with the
    row path."""
    dtype = np.dtype(dtype)
    ls_src = src_pool.get_set(src_set_name)
    ls_dst = dst_pool.create_set(dst_set_name, ls_src.page_size, attrs)
    memory = getattr(dst_pool, "memory", None)
    moved = 0
    for size, src_view in iter_page_images(src_pool, ls_src):
        land_page_image(dst_pool, ls_dst, src_view, memory=memory)
        n = int(src_view[:_HEADER].view(np.int64)[0])
        moved += n * dtype.itemsize
    return moved


class TransferError(RuntimeError):
    """A transfer job failed because one of its dependencies failed."""


class TransferFuture:
    """Result handle for a submitted transfer job."""

    def __init__(self, job_id: int, label: str = ""):
        self.job_id = job_id
        self.label = label
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if timeout is None or timeout > 0:
            # a future wait is a real block (a 0-timeout call is a poll)
            note_blocking("transfer.result")
        if not self._done.wait(timeout):
            raise TimeoutError(f"transfer job {self.label or self.job_id} "
                               f"did not finish within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        self._done.wait(timeout)
        return self._exc

    def _finish(self, result=None, exc: Optional[BaseException] = None):
        self._result = result
        self._exc = exc
        self._done.set()


class _Job:
    __slots__ = ("fn", "args", "kwargs", "future", "deps",
                 "dest", "nbytes", "charged", "held")

    def __init__(self, fn, args, kwargs, future, deps,
                 dest=None, nbytes=0):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.future = future
        self.deps: List[TransferFuture] = deps
        self.dest = dest        # destination key (or callable resolving one)
        self.nbytes = nbytes    # landing bytes (or callable resolving them)
        self.charged = 0        # bytes charged against dest while in flight
        self.held = False       # already counted in dest_holds

    def resolve(self) -> None:
        """Late-bind dest/nbytes (callables become values once deps are
        done — e.g. a reducer pull learns its node from the placement
        job)."""
        if callable(self.dest):
            self.dest = self.dest()
        if callable(self.nbytes):
            self.nbytes = int(self.nbytes())


class TransferEngine:
    """Producer/consumer job pool with dependency ordering.

    ``submit(fn, *args, after=[futs])`` enqueues a job that runs only once
    every future in ``after`` has completed; a failed dependency fails the
    dependent with ``TransferError`` instead of running it. Jobs with no
    pending dependencies go straight to the ready queue that worker threads
    drain. Dependency resolution happens on completion callbacks, never by a
    worker blocking, so the pool cannot deadlock on its own ordering.
    """

    IDLE_EXIT_S = 5.0  # workers exit after this much idleness; respawned lazily

    def __init__(self, num_workers: int = 4, name: str = "transfer",
                 dest_inflight_cap: Optional[int] = None):
        self.num_workers = num_workers
        self.name = name
        self.dest_inflight_cap = dest_inflight_cap
        self._ready: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._lock = tracked_lock("transfer.engine")
        self._pending: List[_Job] = []      # waiting on deps or dest headroom
        self._inflight = 0                  # submitted but not finished
        self._dest_bytes: dict = {}         # dest -> bytes currently in flight
        self.dest_holds = 0                 # jobs held back for dest headroom
        self._workers: List[threading.Thread] = []
        self._idle = tracked_condition("transfer.idle", self._lock)
        self._closed = False
        self._ids = itertools.count()

    # -- worker management ----------------------------------------------------
    def _ensure_workers(self) -> None:
        self._workers = [t for t in self._workers if t.is_alive()]
        while len(self._workers) < self.num_workers:
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"{self.name}-{len(self._workers)}")
            t.start()
            self._workers.append(t)

    def _worker_loop(self) -> None:
        me = threading.current_thread()
        while True:
            try:
                job = self._ready.get(timeout=self.IDLE_EXIT_S)
            except queue.Empty:
                # idle exit — but deregister under the submit lock and
                # re-check the queue there, so a submit that raced the
                # timeout either finds us still listed (we loop again) or
                # sees us gone and spawns a replacement; a job can never
                # strand between an exiting worker and _ensure_workers
                with self._lock:
                    if not self._ready.empty():
                        continue
                    if me in self._workers:
                        self._workers.remove(me)
                    return
            if job is None:  # shutdown sentinel
                return
            self._run(job)

    def _run(self, job: _Job) -> None:
        failed = next((d for d in job.deps if d.exception() is not None), None)
        try:
            if failed is not None:
                raise TransferError(
                    f"dependency {failed.label or failed.job_id} failed: "
                    f"{failed.exception()!r}")
            result = job.fn(*job.args, **job.kwargs)
        except BaseException as exc:  # noqa: BLE001 - delivered via future
            job.future._finish(exc=exc)
        else:
            job.future._finish(result=result)
        self._on_done(job)

    def _dest_admits(self, job: _Job) -> bool:
        """Per-destination in-flight cap (lock held, deps already done): a
        destination with nothing in flight always admits, otherwise the
        job's bytes must fit under the cap on top of what is in flight."""
        if self.dest_inflight_cap is None:
            return True
        job.resolve()
        if job.dest is None or job.nbytes <= 0:
            return True
        inflight = self._dest_bytes.get(job.dest, 0)
        return inflight == 0 or inflight + job.nbytes <= self.dest_inflight_cap

    def _charge(self, job: _Job) -> None:
        if self.dest_inflight_cap is not None and job.dest is not None \
                and not callable(job.dest) and job.nbytes:
            job.charged = job.nbytes
            self._dest_bytes[job.dest] = \
                self._dest_bytes.get(job.dest, 0) + job.charged

    def _try_admit(self, job: _Job) -> Optional[bool]:
        """Admission check with exception isolation (lock held): True =
        admit, False = hold for headroom, None = the job's user-supplied
        dest/nbytes callable raised — its future is failed and the job is
        terminally done (a raising callable must not kill a worker thread
        or hang ``drain`` on a leaked inflight count)."""
        try:
            return self._dest_admits(job)
        except BaseException as exc:  # noqa: BLE001 - delivered via future
            job.future._finish(exc=exc)
            return None

    def _promote_ready(self) -> None:
        """Move every pending job whose deps are done AND whose destination
        has headroom onto the ready queue (lock held). Charges destination
        bytes as jobs are admitted, so one scan can't over-admit. Admission
        per destination is FIFO: once a job for destination D is held, later
        jobs for D stay held too — otherwise a stream of small jobs could
        starve a large held one by forever eating D's headroom."""
        still_pending: List[_Job] = []
        blocked_dests = set()
        for j in self._pending:
            if not all(d.done() for d in j.deps):
                still_pending.append(j)
                continue
            admit = self._try_admit(j)
            if admit is None:
                self._inflight -= 1      # failed without running
                continue
            if admit and j.dest is not None and j.dest in blocked_dests:
                admit = False            # FIFO: an earlier job for this
                                         # dest is already held
            if not admit:
                if not j.held:           # count each held job once
                    j.held = True
                    self.dest_holds += 1
                if j.dest is not None and not callable(j.dest):
                    blocked_dests.add(j.dest)
                still_pending.append(j)
            else:
                self._charge(j)
                self._ready.put(j)
        self._pending = still_pending

    def _on_done(self, job: _Job) -> None:
        with self._lock:
            self._inflight -= 1
            if job.charged:
                left = self._dest_bytes.get(job.dest, 0) - job.charged
                if left > 0:
                    self._dest_bytes[job.dest] = left
                else:
                    self._dest_bytes.pop(job.dest, None)
            self._promote_ready()
            self._idle.notify_all()

    # -- public API ------------------------------------------------------------
    def submit(self, fn: Callable, *args,
               after: Sequence[TransferFuture] = (),
               label: str = "", dest=None, nbytes=0,
               **kwargs) -> TransferFuture:
        """Enqueue a job. ``dest``/``nbytes`` (values or callables resolved
        once deps finish) declare where the job's bytes land and how many,
        for the per-destination in-flight cap; jobs without them are
        unmetered."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        future = TransferFuture(next(self._ids), label or getattr(fn, "__name__", ""))
        job = _Job(fn, args, kwargs, future, list(after),
                   dest=dest, nbytes=nbytes)
        with self._lock:
            self._inflight += 1
            self._ensure_workers()
            # one admission path for every job: append in submission order
            # and let the scan admit — it enforces deps, dest headroom, and
            # per-destination FIFO in one place (a fast path here would let
            # a newcomer slip past an earlier job the scan hasn't marked
            # held yet)
            self._pending.append(job)
            self._promote_ready()
            self._idle.notify_all()
        return future

    def map(self, fn: Callable, items: Sequence,
            after: Sequence[TransferFuture] = ()) -> List[TransferFuture]:
        return [self.submit(fn, item, after=after) for item in items]

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted job has finished."""
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout):
                raise TimeoutError(
                    f"{self._inflight} transfer jobs still in flight")

    def shutdown(self) -> None:
        """Finish outstanding work, then stop the workers."""
        self.drain()
        self._closed = True
        for _ in self._workers:
            self._ready.put(None)

    def __enter__(self) -> "TransferEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
