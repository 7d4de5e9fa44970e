"""Checkpointing: sharded, checksummed, async, with HETEROGENEOUS LAYOUTS.

Paper §7 applied to tensor state: a checkpoint can be written under multiple
partitionings (e.g. ``row`` = FSDP-major and ``col`` = TP-major). They do
double duty:

* restore picks the layout matching the target mesh (no reshard pass);
* a lost/corrupt shard of one layout is REBUILT from the other layout's
  surviving shards (each row-shard intersects every col-shard, so any
  single lost shard — or any set of shards from one layout — is recoverable
  without a full second copy of the same partitioning).

Two backends share the encode/verify/recover logic:

* **File mode** (``CheckpointManager(directory)``): the original format —
  ``<dir>/step_<n>/<layout>/shard_<i>.npz`` + ``manifest.json`` with
  shapes/dtypes/crc32 per shard, plus a ``latest`` pointer written
  atomically.
* **Pool mode** (``CheckpointManager(cluster=...)``): every blob is a
  write-through locality set streamed through a node's buffer pool, so the
  bytes land in that node's durable page log — checkpoints ride the same
  storage tier as user data, survive a node restart, and warm-restore from
  the replayed log without touching the network. Blob placement is recorded
  in ``Cluster.durable_blobs`` so the revival fence keeps them.

Copy of the JAX package's ``checkpoint/manager.py``, with the same blob names,
manifest and npz bytes, so that each package restores the other's
checkpoints. What changes is at the edges, for torch. A leaf may be a numpy
array or a torch tensor on any device. A bf16 tensor is stored as the
reference stores a bf16 array: its bits in an npz entry of descr ``<V2``, and
``bfloat16`` in the manifest. ``restore`` with a torch template gives every
leaf back as a CPU tensor of the template leaf's dtype, by a bit view (bf16
again, where the reference gives numpy's two-byte void); with a numpy
template it gives the stored arrays, as the reference does.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zipfile
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.services import user_data_attrs

Pytree = Any


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip("/")] = _leaf_array(tree)
    return out


#: how a bf16 leaf's bits sit in a numpy array: numpy has no bf16, and an npz
#: entry of a bf16 array loads as this two-byte void
_BF16 = np.dtype("V2")


def _leaf_array(leaf) -> np.ndarray:
    """One leaf as numpy: a tensor is copied to the host, bf16 as its bits
    (a CPU tensor copied too: the train step updates a donated state in
    place while an asynchronous save may still be writing this copy)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.view(_BF16) if arr.dtype.name == "bfloat16" else arr


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def _restored_leaf(template, arr: np.ndarray):
    """A stored array in the template leaf's type: a torch template gets a
    CPU tensor of its dtype by a bit view; anything else gets ``arr``."""
    if not isinstance(template, torch.Tensor):
        return arr
    if arr.dtype.itemsize != template.element_size():
        raise ValueError(f"stored {_dtype_name(arr)} leaf cannot be viewed "
                         f"as {template.dtype}")
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return torch.from_numpy(raw).view(template.dtype).reshape(arr.shape)


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    if template is None:
        return None
    return _restored_leaf(template, flat[prefix.rstrip("/")])


# ---------------------------------------------------------------------------
# Layouts: how a tensor is split into shards
# ---------------------------------------------------------------------------
def _split_indices(n: int, shards: int) -> List[Tuple[int, int]]:
    base, rem = divmod(n, shards)
    out, start = [], 0
    for i in range(shards):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


@dataclass(frozen=True)
class Layout:
    """Partition every tensor along one axis choice rule."""

    name: str
    axis_fn: Callable[[np.ndarray], int]   # array -> axis to split (or -1)

    def shard_slices(self, arr: np.ndarray, shards: int):
        ax = self.axis_fn(arr)
        if ax < 0 or arr.ndim == 0 or arr.shape[ax] < shards:
            # replicate small tensors on shard 0
            return [(0, None)]
        return [(i, (ax, lo, hi)) for i, (lo, hi) in
                enumerate(_split_indices(arr.shape[ax], shards))]


ROW = Layout("row", lambda a: 0 if a.ndim >= 1 else -1)
COL = Layout("col", lambda a: a.ndim - 1 if a.ndim >= 2 else
             (0 if a.ndim == 1 else -1))
LAYOUTS = {"row": ROW, "col": COL}


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _npz_bytes(tensors: Dict[str, np.ndarray]) -> bytes:
    """``np.savez``'s bytes, except that a bf16 leaf's header says ``<V2``
    as numpy writes it for a bf16 array (plain two-byte void says ``|V2``)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in tensors.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype != _BF16:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                    continue
                header = np.lib.format.header_data_from_array_1_0(arr)
                header["descr"] = "<V2"
                np.lib.format.write_array_header_1_0(f, header)
                f.write(arr.tobytes("F" if header["fortran_order"] else "C"))
    return buf.getvalue()


class CheckpointManager:
    def __init__(self, directory: Optional[str] = None,
                 layouts: Sequence[str] = ("row",),
                 num_shards: int = 4, keep: int = 3,
                 cluster=None, page_size: int = 1 << 16,
                 prefix: str = "ckpt"):
        if (directory is None) == (cluster is None):
            raise ValueError(
                "exactly one of directory= (file mode) or cluster= "
                "(pool mode) must be given")
        self.dir = directory
        self.cluster = cluster
        self.page_size = page_size
        self.prefix = prefix
        self.layouts = [LAYOUTS[l] for l in layouts]
        self.num_shards = num_shards
        self.keep = keep
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Pytree, async_: bool = False) -> None:
        self.wait()  # drain any in-flight async save first
        flat = _flatten(state)
        if async_:

            def run():
                try:
                    self._write(step, flat)
                except BaseException as e:  # noqa: BLE001
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _encode(self, step: int,
                flat: Dict[str, np.ndarray]) -> Dict[str, bytes]:
        """Shard the flattened state under every layout. Returns relative
        blob name -> bytes, with ``manifest.json`` describing every shard's
        shape/dtype/crc32 (both backends publish exactly these blobs)."""
        manifest: Dict[str, Any] = {"step": step, "layouts": {},
                                    "tensors": {k: {"shape": list(v.shape),
                                                    "dtype": _dtype_name(v)}
                                                for k, v in flat.items()}}
        blobs: Dict[str, bytes] = {}
        for layout in self.layouts:
            shards: Dict[int, Dict[str, np.ndarray]] = {
                i: {} for i in range(self.num_shards)}
            meta: Dict[str, Any] = {}
            for key, arr in flat.items():
                placements = layout.shard_slices(arr, self.num_shards)
                if placements == [(0, None)]:
                    shards[0][key] = arr
                    meta[key] = {"replicated": True, "crc": [_crc(arr)]}
                else:
                    crcs = []
                    for i, (ax, lo, hi) in placements:
                        sl = [slice(None)] * arr.ndim
                        sl[ax] = slice(lo, hi)
                        piece = arr[tuple(sl)]
                        shards[i][key] = piece
                        crcs.append(_crc(piece))
                    meta[key] = {"axis": placements[0][1][0], "crc": crcs,
                                 "bounds": [list(p[1][1:]) for p in placements]}
            for i, tensors in shards.items():
                blobs[f"{layout.name}/shard_{i}.npz"] = _npz_bytes(tensors)
            manifest["layouts"][layout.name] = meta
        blobs["manifest.json"] = json.dumps(manifest).encode()
        return blobs

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        step_name = f"step_{step:08d}"
        blobs = self._encode(step, flat)
        if self.cluster is not None:
            self._publish_pool(step_name, blobs)
        else:
            self._publish_files(step_name, blobs)
        self._gc()

    def _publish_files(self, step_name: str, blobs: Dict[str, bytes]) -> None:
        final = os.path.join(self.dir, step_name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for rel, data in blobs.items():
            path = os.path.join(tmp, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(step_name)
        os.replace(os.path.join(self.dir, "latest.tmp"),
                   os.path.join(self.dir, "latest"))

    def _publish_pool(self, step_name: str, blobs: Dict[str, bytes]) -> None:
        """Stream every blob through a node's buffer pool as a write-through
        set (its pages persist into the node's durable page log on unpin —
        paper §4's write-through). The manifest lands last as
        the commit point; the latest pointer flips after it."""
        shard_blobs = sorted(r for r in blobs if r != "manifest.json")
        for rel in shard_blobs + ["manifest.json"]:
            self._put_blob(f"{self.prefix}/{step_name}/{rel}", blobs[rel])
        self._put_blob(f"{self.prefix}/latest", step_name.encode())

    def _gc(self) -> None:
        for name in self._list_steps()[:-self.keep]:
            self._delete_step(name)

    # ------------------------------------------------------- blob primitives
    def _blob_names(self) -> List[str]:
        return [n for n in self.cluster.durable_blobs
                if n.startswith(f"{self.prefix}/")]

    def _put_blob(self, name: str, data: bytes) -> None:
        cluster = self.cluster
        if name in cluster.durable_blobs:
            self._del_blob(name)
        alive = cluster.alive_node_ids()
        node_id = alive[zlib.crc32(name.encode()) % len(alive)]
        records = np.frombuffer(data, dtype=np.uint8)
        cluster.nodes[node_id].write_records(
            name, records, np.dtype(np.uint8), self.page_size,
            user_data_attrs())
        cluster.register_durable_blob(name, node_id)

    def _get_blob(self, name: str) -> bytes:
        loc = self.cluster.durable_blobs.get(name)
        if loc is None:
            raise FileNotFoundError(f"no blob {name!r}")
        node = self.cluster.node(loc[0])  # DeadNodeError while it is down
        pool = node.pool
        if name not in pool.paging.sets:
            # warm restore: the set is not registered in the fresh pool but
            # its page images survive in the replayed durable log
            log = pool.memory.pagelog
            if log is None or not log.entries_for(name):
                raise IOError(f"blob {name!r} lost with node {loc[0]}")
            pool.adopt_durable_set(name, self.page_size, user_data_attrs())
        return node.read_records(name, np.dtype(np.uint8)).tobytes()

    def _del_blob(self, name: str) -> None:
        loc = self.cluster.durable_blobs.get(name)
        self.cluster.unregister_durable_blob(name)
        if loc is None:
            return
        node = self.cluster.nodes[loc[0]]
        if (node.alive and node.pool is not None
                and name in node.pool.paging.sets):
            node.pool.drop_set(node.pool.get_set(name))

    def _read_rel(self, step_name: str, rel: str) -> bytes:
        if self.cluster is not None:
            return self._get_blob(f"{self.prefix}/{step_name}/{rel}")
        with open(os.path.join(self.dir, step_name, rel), "rb") as f:
            return f.read()

    def _list_steps(self) -> List[str]:
        if self.cluster is not None:
            pre = f"{self.prefix}/"
            return sorted({n[len(pre):].split("/")[0]
                           for n in self._blob_names()
                           if n[len(pre):].startswith("step_")})
        return sorted(d for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def _delete_step(self, step_name: str) -> None:
        if self.cluster is not None:
            pre = f"{self.prefix}/{step_name}/"
            for name in [n for n in self._blob_names()
                         if n.startswith(pre)]:
                self._del_blob(name)
            return
        shutil.rmtree(os.path.join(self.dir, step_name), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        if self.cluster is not None:
            if f"{self.prefix}/latest" not in self.cluster.durable_blobs:
                return None
            pointer = self._get_blob(f"{self.prefix}/latest").decode()
            return int(pointer.strip().split("_")[1])
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, template: Pytree, step: Optional[int] = None,
                layout: Optional[str] = None) -> Pytree:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        step_name = f"step_{step:08d}"
        manifest = json.loads(self._read_rel(step_name, "manifest.json"))
        names = ([layout] if layout else list(manifest["layouts"]))
        last_err: Optional[BaseException] = None
        for name in names:
            try:
                flat = self._read_layout(step_name, manifest, name)
                return _unflatten_into(template, flat)
            except Exception as e:  # noqa: BLE001 — fall through to next layout
                last_err = e
        # single layouts failed wholesale; try cross-layout recovery
        flat = self.recover(step_name, manifest)
        if flat is not None:
            return _unflatten_into(template, flat)
        raise IOError(
            f"checkpoint step {step} unrecoverable from any layout "
            f"(last error: {last_err!r})")

    def _load_shard(self, step_name: str, layout: str,
                    shard: int) -> Dict[str, np.ndarray]:
        data = self._read_rel(step_name, f"{layout}/shard_{shard}.npz")
        return dict(np.load(io.BytesIO(data)))

    def _read_layout(self, step_name: str, manifest: Dict, name: str,
                     verify: bool = True) -> Dict[str, np.ndarray]:
        meta = manifest["layouts"][name]
        shard_data = [self._load_shard(step_name, name, i)
                      for i in range(self.num_shards)]
        out: Dict[str, np.ndarray] = {}
        for key, info in meta.items():
            if info.get("replicated"):
                arr = shard_data[0][key]
                if verify and _crc(arr) != info["crc"][0]:
                    raise IOError(f"crc mismatch for {key} (replicated)")
                out[key] = arr
                continue
            pieces = []
            for i in range(self.num_shards):
                piece = shard_data[i][key]
                if verify and _crc(piece) != info["crc"][i]:
                    raise IOError(f"crc mismatch for {key} shard {i}")
                pieces.append(piece)
            out[key] = np.concatenate(pieces, axis=info["axis"])
        return out

    # -------------------------------------------------------------- recovery
    def recover(self, step_name: str,
                manifest: Dict) -> Optional[Dict[str, np.ndarray]]:
        """Rebuild tensors, taking each one from whichever layout still has a
        valid copy (paper-§7 recovery across heterogeneous replicas: a lost
        row-shard is reassembled from the column-partitioned replica)."""
        flats = {}
        for name in manifest["layouts"]:
            try:
                flats[name] = self._read_layout(step_name, manifest, name)
            except Exception:  # noqa: BLE001
                flats[name] = None
        good = [f for f in flats.values() if f is not None]
        if good:
            return good[0]
        # per-tensor salvage: mix layouts (any tensor valid in some layout)
        out: Dict[str, np.ndarray] = {}
        for key, tinfo in manifest["tensors"].items():
            rebuilt = None
            for name in manifest["layouts"]:
                try:
                    part = self._read_single(step_name, manifest, name, key)
                    rebuilt = part
                    break
                except Exception:  # noqa: BLE001
                    continue
            if rebuilt is None:
                return None
            out[key] = rebuilt
        return out

    def _read_single(self, step_name: str, manifest: Dict, name: str,
                     key: str) -> np.ndarray:
        meta = manifest["layouts"][name][key]
        if meta.get("replicated"):
            arr = self._load_shard(step_name, name, 0)[key]
            if _crc(arr) != meta["crc"][0]:
                raise IOError("crc")
            return arr
        pieces = []
        for i in range(self.num_shards):
            piece = self._load_shard(step_name, name, i)[key]
            if _crc(piece) != meta["crc"][i]:
                raise IOError("crc")
            pieces.append(piece)
        return np.concatenate(pieces, axis=meta["axis"])

    def damage_shard(self, step: int, layout: str, shard: int) -> None:
        """Test hook: simulate a lost/corrupt shard (file or blob)."""
        if self.cluster is not None:
            name = (f"{self.prefix}/step_{step:08d}/{layout}/"
                    f"shard_{shard}.npz")
            self._del_blob(name)
            self._put_blob(name, b"corrupt")
            return
        p = os.path.join(self.dir, f"step_{step:08d}", layout,
                         f"shard_{shard}.npz")
        with open(p, "wb") as f:
            f.write(b"corrupt")
