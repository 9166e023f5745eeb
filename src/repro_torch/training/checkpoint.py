"""Snapshot-bound checkpointing: the paper's lifecycle argument applied to
training state.

Port of ``repro/training/checkpoint.py``.  A checkpoint is committed through
the same Iceberg-style catalog as table data: each leaf of the state tree is
one immutable ``.npy`` object, the manifest lists them, and the snapshot
summary carries the step and metrics.  So a crash mid-save leaves objects no
snapshot lists, which orphan GC reaps; readers see only committed
checkpoints; any retained step can be restored; and training resumes from
the latest committed snapshot.

The objects are the reference's: the same leaf names (dict keys in sorted
order, a NamedTuple field as ``.name``, a sequence item as its index, joined
by ``/``), the same keys (``step-XXXXXXXX/<name with / -> _>.npy``) and the
same bytes (``np.save`` of the unsharded leaf), so a checkpoint saved by
either package restores in the other.  A bf16 leaf is saved in the bytes
the reference writes for one (two-byte void records, descr ``<V2``), and
restored by reinterpreting them as the dtype of a two-byte leaf of
``like`` (the reference hands such a leaf back as a ``|V2`` array).

``save`` copies every leaf to the host before its thread starts: the train
step updates the state in place, and on the CPU ``Tensor.numpy()`` shares
memory with the tensor, so a later step would rewrite the saved arrays.
"""

from __future__ import annotations

import io
import json
import threading
import uuid
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.iceberg.catalog import RestCatalog
from repro_torch.iceberg.snapshot import (
    DataFile,
    FileStatus,
    Manifest,
    ManifestEntry,
    Snapshot,
    live_data_files,
    new_snapshot_id,
    now_ms,
    write_manifest_list,
)
from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.models.sharding import is_dtensor, local_block

PUT_WORKERS = 4  # leaves hashed and written at once by a save's thread


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(name, leaf)] in the reference's pytree order and naming."""
    join = (lambda part: f"{prefix}/{part}") if prefix else (lambda part: part)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_paths(tree[k], join(str(k)))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in _flatten_with_paths(v, join(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_paths(v, join(str(i)))]
    return [(prefix, tree)]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _host_npy(t: torch.Tensor) -> bytearray:
    """``np.save``'s bytes of ``t``, a host copy no later in-place update
    reaches: the tensor is copied from its device straight into the data
    region of the file's buffer.  A bf16 leaf gets the header the
    reference's ``np.save`` of an ml_dtypes bfloat16 array writes (descr
    ``<V2``; plain numpy would write ``|V2``)."""
    t = t.detach()
    if is_dtensor(t):  # a leaf placed on a mesh is written whole
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        descr, t = "<V2", t.view(torch.int16)
    else:
        descr = np.lib.format.dtype_to_descr(_np_dtype(t.dtype))
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, {"descr": descr, "fortran_order": False, "shape": tuple(t.shape)})
    header = head.getvalue()
    buf = bytearray(len(header) + t.numel() * t.element_size())
    buf[:len(header)] = header
    dst = np.frombuffer(buf, dtype=_np_dtype(t.dtype), count=t.numel(), offset=len(header))
    torch.from_numpy(dst).view(t.shape).copy_(t)
    return buf


_READ_HEADER = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _fill(dst: torch.Tensor, data: bytes) -> None:
    """Copies a leaf's ``.npy`` bytes into ``dst`` in ``dst``'s dtype,
    reading the array where it lies in ``data`` (no second host copy)."""
    f = io.BytesIO(data)
    shape, fortran, dtype = _READ_HEADER[np.lib.format.read_magic(f)](f)
    if fortran or dtype.hasobject:
        raise ValueError(f"unsupported checkpoint leaf: {dtype}, fortran_order={fortran}")
    if tuple(shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {tuple(shape)} != {tuple(dst.shape)}")
    void = dtype.kind == "V"
    if void:
        if dtype.itemsize != dst.element_size():
            raise ValueError(f"a {dtype} leaf cannot restore into {dst.dtype}")
        dtype = np.dtype(np.int16)
    arr = np.frombuffer(data, dtype=dtype, count=int(np.prod(shape)), offset=f.tell()).reshape(shape)
    with warnings.catch_warnings():
        # read only: the bytes are copied to ``dst`` and never written
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        src = torch.from_numpy(arr)
    if is_dtensor(dst):  # a leaf placed on a mesh takes its rank's block
        src = local_block(src, dst.device_mesh, dst.placements)
        dst = dst.to_local()
    dst.copy_(src.view(dst.dtype) if void else src)


class CheckpointManager:
    def __init__(
        self,
        catalog: RestCatalog,
        name: str = "__checkpoints",
        *,
        async_save: bool = True,
        keep_last: int = 3,
    ) -> None:
        self.catalog = catalog
        self.store: ObjectStore = catalog.store
        self.name = name
        self.async_save = async_save
        self.keep_last = keep_last
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        if not catalog.table_exists(name):
            catalog.create_table(name, {"leaf": "bytes"})

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        """Write the leaves of ``state``, a tree of tensors (on a thread if
        ``async_save``), then commit the snapshot from that thread."""
        self.wait()  # one in-flight save at a time
        leaves = [(name, _host_npy(leaf)) for name, leaf in _flatten_with_paths(state)]
        summary = {"ckpt.step": str(step)}
        if metrics:
            summary["ckpt.metrics"] = json.dumps({k: float(v) for k, v in metrics.items()})
        meta = self.catalog.load_table(self.name)

        def put(name, data):
            key = f"{meta.location}/data/step-{step:08d}/{name.replace('/', '_')}.npy"
            self.store.put(key, data)
            return DataFile(path=key, record_count=1, file_size_bytes=len(data))

        def do_save():
            # the puts overlap their hashing (the store serialises the
            # writes); a host copy is dropped once its put is done
            with ThreadPoolExecutor(max_workers=PUT_WORKERS) as pool:
                futures = [pool.submit(put, *leaves.pop(0)) for _ in range(len(leaves))]
                files = [f.result() for f in futures]

            # checkpoints replace rather than accumulate: commit only this
            # step's files as the live set
            def mutate(m):
                token = uuid.uuid4().hex[:12]
                mpath = f"{m.location}/metadata/manifest-{token}.json"
                lpath = f"{m.location}/metadata/manifest-list-{token}.json"
                Manifest.write(self.store, mpath, [ManifestEntry(FileStatus.ADDED, f) for f in files])
                write_manifest_list(self.store, lpath, [mpath])
                parent = m.current_snapshot()
                snap = Snapshot(
                    snapshot_id=new_snapshot_id(),
                    parent_snapshot_id=parent.snapshot_id if parent else None,
                    sequence_number=(parent.sequence_number + 1) if parent else 1,
                    timestamp_ms=now_ms(),
                    manifest_list=lpath,
                    operation="overwrite",
                    summary=summary,
                )
                m.snapshots.append(snap)
                m.current_snapshot_id = snap.snapshot_id
                # retention
                if len(m.snapshots) > self.keep_last:
                    m.snapshots = m.snapshots[-self.keep_last:]
                return m

            self.catalog.commit_with_retries(self.name, mutate)

        if self.async_save:
            def run():
                try:
                    do_save()
                except Exception as e:  # re-raised by wait()
                    self._error = e

            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()
        else:
            do_save()

    def wait(self) -> None:
        """Joins the save in flight; raises what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        self.wait()
        meta = self.catalog.load_table(self.name)
        snap = meta.current_snapshot()
        if snap is None or "ckpt.step" not in snap.summary:
            return None
        return int(snap.summary["ckpt.step"])

    def available_steps(self) -> list:
        self.wait()
        meta = self.catalog.load_table(self.name)
        return sorted(int(s.summary["ckpt.step"]) for s in meta.snapshots if "ckpt.step" in s.summary)

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restores the latest committed checkpoint (or ``step``) into the
        tensors of ``like``, in place, leaf by leaf (each converted to its
        leaf's dtype on its leaf's device), and returns ``(like, step)``.
        ``like`` is overwritten: pass copies to keep its values."""
        self.wait()
        meta = self.catalog.load_table(self.name)
        snap = None
        if step is None:
            snap = meta.current_snapshot()
        else:
            for s in meta.snapshots:
                if s.summary.get("ckpt.step") == str(step):
                    snap = s
                    break
        if snap is None or "ckpt.step" not in snap.summary:
            raise FileNotFoundError("no checkpoint found")
        files = {f.path.rsplit("/", 1)[-1]: f.path for f in live_data_files(self.store, snap)}
        with torch.no_grad():
            for name, leaf in _flatten_with_paths(like):
                _fill(leaf, self.store.get(files[name.replace("/", "_") + ".npy"]))
        return like, int(snap.summary["ckpt.step"])
