"""StreamStore — the framework's "database" (paper advantages (1)+(3)).

The paper persists both the original and the simulated stream so that
(1) the framework depends on nothing but a database, and (3) exceptions are
traceable and processed data is reusable ("repeated normalizing and sampling
operations are not performed").

Here: an on-disk column store. Each stream is a directory holding one
``columns.npz`` plus a ``manifest.json``; writes go through a temp file +
``os.replace`` so a crash mid-write never corrupts a stream.

The on-disk format is the reference's (``repro.streamsim.store``) byte for
byte in layout: either package reads a store the other wrote, and
participants of either package can serve one sweep-service queue. The
marker primitives are the reference's: ``put_marker(..., exclusive=True)``
(one winner of N concurrent creators), ``claim_marker`` (one ``os.replace``
between namespaces: one winner of N claimants) and ``clear_markers``
(rename, then delete), which the checkpoint and the sweep service
(:mod:`repro_torch.streamsim.service`) build on. A stream is visible only
once its manifest is written, after its columns were renamed into place,
so two processes preparing the same original never read half of one.

Reading. ``get`` reads a ``columns.npz`` in place, not through
``np.load``: it finds each member's array from the zip's central directory,
the member's local header and its npy header, then reads each time column
(``__t__``, ``__scale_stamp__``: every consumer reads them whole) with one
``readinto`` into an array of its own, and maps the payload columns
(``c:*``: NSA keeps a few rows of them, gathered later) with
``np.frombuffer`` over one private, copy-on-write ``mmap`` of the file. A
payload column is thus an ordinary writable ``ndarray`` whose writes never
reach the file, and whose pages are read when a gather touches them; the
map lives as long as its arrays, and deleting the stream while they live
leaves them readable. A file whose members cannot all be placed so
(compressed members, object or structured dtypes, Fortran order over more
than one axis, a bad signature, data past the end, an empty or truncated
file) is read by ``np.load`` as before, which raises where the file is
broken. Chunked streams are concatenated from ``np.load`` reads.

The in-place read does not run the zip's CRC32 check that ``np.load``
does. Nothing the store promises rests on it: a stream becomes visible
only when its manifest is renamed into place, after its columns were
written to a temp file and renamed (so no reader sees a half-written
file), and a file changed afterwards is no failure the store guards
against.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
import tempfile
import time
import uuid
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.streamsim.preprocess import Stream

_MANIFEST = "manifest.json"
_COLUMNS = "columns.npz"
#: the members ``get`` reads whole; the others it reads are payload columns
_TIME_COLUMNS = ("__t__", "__scale_stamp__")
_LOCAL_HEADER = struct.Struct("<4s22xHH")


def _wanted(key: str) -> bool:
    return key in _TIME_COLUMNS or key.startswith("c:")


def _members_in_place(f) -> Optional[Dict[str, Tuple[int, np.dtype, tuple]]]:
    """Where the array of each member that ``get`` reads lies in the open
    npz ``f``: key -> (data offset, dtype, shape). None where one cannot be
    read in place: the file is no zip, a member is compressed, encrypted or
    no ``.npy``, its local header lacks its signature, its npy header is
    not version 1.0 or 2.0, its dtype holds objects, fields or no bytes,
    it is in Fortran order over more than one axis, or its data runs past
    the member's or the file's end."""
    size = os.fstat(f.fileno()).st_size
    try:
        with zipfile.ZipFile(f) as z:
            infos = z.infolist()
    except zipfile.BadZipFile:
        return None
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    for info in infos:
        key = info.filename[:-len(".npy")]
        if (not info.filename.endswith(".npy")
                or info.compress_type != zipfile.ZIP_STORED
                or info.flag_bits & 1):
            return None
        if not _wanted(key):
            continue
        # the data starts after the LOCAL header's name and extra field,
        # whose lengths differ from the central directory's (np.savez
        # writes a zip64 extra field only there)
        f.seek(info.header_offset)
        head = f.read(_LOCAL_HEADER.size)
        if len(head) < _LOCAL_HEADER.size:
            return None
        sig, name_len, extra_len = _LOCAL_HEADER.unpack(head)
        if sig != b"PK\x03\x04":
            return None
        start = f.tell() + name_len + extra_len
        f.seek(start)
        try:
            read_header = readers.get(np.lib.format.read_magic(f))
            if read_header is None:
                return None
            shape, fortran_order, dtype = read_header(f)
        except ValueError:
            return None
        offset = f.tell()
        if (dtype.hasobject or dtype.names is not None or not dtype.itemsize
                or (fortran_order and len(shape) > 1)
                or offset + math.prod(shape) * dtype.itemsize
                > min(start + info.file_size, size)):
            return None
        out[key] = (offset, dtype, shape)
    return out


def _read_in_place(f, members) -> Tuple[Dict[str, np.ndarray], int]:
    """The columns of the open npz ``f`` that :func:`_members_in_place`
    placed, and the bytes mapped: a time column in one read into an array
    of its own, the payload columns as views of one private map of the
    file."""
    columns, mapped, view = {}, 0, None
    for key, (offset, dtype, shape) in members.items():
        if key in _TIME_COLUMNS:
            a = np.empty(shape, dtype)
            f.seek(offset)
            if f.readinto(a.reshape(-1).view(np.uint8)) != a.nbytes:
                raise EOFError(f"{f.name}: {key!r} ends past the file")
        else:
            if view is None:
                view = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            a = np.frombuffer(view, dtype, math.prod(shape),
                              offset).reshape(shape)
            mapped += a.nbytes
        columns[key] = a
    return columns, mapped


class StreamStore:
    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ keys
    def _dir(self, key: str) -> Path:
        if "/" in key or key.startswith("."):
            raise ValueError(f"bad stream key {key!r}")
        return self.root / key

    def list(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir()
                      if (p / _MANIFEST).exists())

    def exists(self, key: str) -> bool:
        return (self._dir(key) / _MANIFEST).exists()

    # ------------------------------------------------------------------- put
    def put(self, key: str, stream: Stream,
            extra_meta: Optional[Dict] = None) -> None:
        d = self._dir(key)
        d.mkdir(parents=True, exist_ok=True)
        self._write_columns(d, d / _COLUMNS, stream)
        manifest = {
            "name": stream.name,
            "rows": len(stream),
            "has_scale_stamp": stream.scale_stamp is not None,
            "time_range_s": stream.time_range,
            "nbytes": stream.nbytes(),
            "written_at": time.time(),
            "extra": extra_meta or {},
        }
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, indent=2)
            os.replace(tmp, d / _MANIFEST)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def _write_columns(d: Path, target: Path, stream: Stream) -> None:
        """``stream``'s columns as one npz at ``target``: written to a temp
        file in ``d``, then renamed into place, so a crash mid-write never
        leaves half a file. The span ``store.write`` counts the bytes."""
        arrays: Dict[str, np.ndarray] = {"__t__": stream.t}
        if stream.scale_stamp is not None:
            arrays["__scale_stamp__"] = stream.scale_stamp
        for k, v in stream.payload.items():
            arrays[f"c:{k}"] = v
        with tracing.span("store.write") as sp:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **arrays)
                    sp.count(bytes=f.tell())
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

    def put_many(self, items: Dict[str, Stream],
                 extra_meta: Optional[Dict[str, Dict]] = None) -> None:
        """Persist several streams in one pass (the sweep engine's
        ``materialize()`` uses this so a whole sweep's store round-trip is
        one call, not one per scenario). ``extra_meta`` optionally maps
        each key to its manifest extras. Atomicity stays per stream —
        a crash mid-batch leaves every already-written stream intact."""
        extra_meta = extra_meta or {}
        for key, stream in items.items():
            self.put(key, stream, extra_meta.get(key))

    # ----------------------------------------------------------- chunk put
    # The chunked pipeline persists one time chunk at a time so a
    # multi-day run never holds (or rewrites) the whole stream on host.
    # Each chunk is its own atomically-renamed ``columns.00042.npz``;
    # the manifest (written LAST, by ``finalize_chunks``) is what makes
    # the key visible to ``exists()``/``get()``, so a kill mid-run leaves
    # a resumable pile of chunk files, never a half-stream. ``get`` then
    # concatenates transparently — callers can't tell a chunked stream
    # from a monolithic one.

    @staticmethod
    def _chunk_file(d: Path, chunk_idx: int) -> Path:
        if chunk_idx < 0:
            raise ValueError(f"bad chunk index {chunk_idx}")
        return d / f"columns.{chunk_idx:05d}.npz"

    def append_chunk(self, key: str, chunk_idx: int, stream: Stream,
                     overwrite: bool = False) -> bool:
        """Persist one time chunk of ``key`` (atomic per chunk).

        Returns False (and writes nothing) when the chunk file already
        exists and ``overwrite`` is unset — the chunk-granular resume
        path: a restarted run calls ``append_chunk`` for every chunk and
        only the missing tail actually hits the disk.
        """
        d = self._dir(key)
        target = self._chunk_file(d, chunk_idx)
        if target.exists() and not overwrite:
            return False
        d.mkdir(parents=True, exist_ok=True)
        self._write_columns(d, target, stream)
        return True

    def has_chunk(self, key: str, chunk_idx: int) -> bool:
        return self._chunk_file(self._dir(key), chunk_idx).exists()

    def list_chunks(self, key: str) -> List[int]:
        d = self._dir(key)
        if not d.exists():
            return []
        out = []
        for p in d.iterdir():
            name = p.name
            if (name.startswith("columns.") and name.endswith(".npz")
                    and name != _COLUMNS):
                mid = name[len("columns."):-len(".npz")]
                if mid.isdigit():
                    out.append(int(mid))
        return sorted(out)

    def finalize_chunks(self, key: str, *, name: str, n_chunks: int,
                        extra_meta: Optional[Dict] = None,
                        stats: Optional[Dict] = None) -> None:
        """Write the manifest that turns ``n_chunks`` appended chunk files
        into one visible stream. Verifies the chunk set is complete
        (missing chunk ⇒ ValueError, key stays invisible).

        ``stats`` (keys ``rows``, ``nbytes``, ``time_range_s``) lets a
        writer that held every chunk in memory skip the re-read this
        method otherwise does to assemble the manifest — the chunked
        sweep runner's hot path. Without it, the chunk files are read
        back (the standalone / recovery path).
        """
        d = self._dir(key)
        have = set(self.list_chunks(key))
        missing = [i for i in range(n_chunks) if i not in have]
        if missing:
            raise ValueError(
                f"cannot finalize {key!r}: missing chunk(s) {missing[:8]}")
        if stats is not None:
            rows = int(stats["rows"])
            nbytes = int(stats["nbytes"])
            time_range_s = float(stats["time_range_s"])
        else:
            rows = 0
            nbytes = 0
            t_first = t_last = None
            for i in range(n_chunks):
                with np.load(self._chunk_file(d, i),
                             allow_pickle=False) as z:
                    t = z["__t__"]
                    rows += len(t)
                    nbytes += sum(int(z[k].nbytes) for k in z.files)
                    if len(t):
                        if t_first is None:
                            t_first = float(t[0])
                        t_last = float(t[-1])
            time_range_s = ((t_last - t_first)
                            if t_first is not None else 0.0)
        manifest = {
            "name": name,
            "rows": rows,
            "has_scale_stamp": True,
            "time_range_s": time_range_s,
            "nbytes": nbytes,
            "written_at": time.time(),
            "chunks": n_chunks,
            "extra": extra_meta or {},
        }
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, indent=2)
            os.replace(tmp, d / _MANIFEST)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # ------------------------------------------------------------------- get
    def get(self, key: str) -> Stream:
        """The stream stored under ``key``. Of a ``columns.npz``, ``t`` and
        ``scale_stamp`` are read whole, one read each, and the payload
        columns are copy-on-write views of a map of the file, with no CRC32
        check; chunk files, and a file whose members cannot all be placed,
        are read by ``np.load`` (the module docstring's "Reading" says when,
        and why the store's atomicity does not rest on the CRC). The span
        ``store.read`` counts the files' ``bytes`` and the ``mapped`` bytes
        of them (0 where ``np.load`` read them)."""
        d = self._dir(key)
        man = self.manifest(key)
        n_chunks = int(man.get("chunks", 0))
        files = ([self._chunk_file(d, i) for i in range(n_chunks)]
                 or [d / _COLUMNS])
        with tracing.span("store.read") as sp:
            if sp:
                sp.count(bytes=sum(os.path.getsize(p) for p in files))
            stream, mapped = self._load(man["name"], files,
                                        chunked=n_chunks > 0)
            sp.count(mapped=mapped)
            return stream

    @staticmethod
    def _load(name: str, files: List[Path],
              chunked: bool) -> Tuple[Stream, int]:
        """The stream in ``files``, and the bytes of them that are mapped."""
        if chunked:
            ts, sss, payloads = [], [], []
            for p in files:
                with np.load(p, allow_pickle=False) as z:
                    ts.append(z["__t__"])
                    if "__scale_stamp__" in z.files:
                        sss.append(z["__scale_stamp__"])
                    payloads.append({k[2:]: z[k] for k in z.files
                                     if k.startswith("c:")})
            t = np.concatenate(ts) if ts else np.empty(0)
            ss = np.concatenate(sss) if len(sss) == len(files) else None
            cols = payloads[0].keys() if payloads else ()
            payload = {c: np.concatenate([p[c] for p in payloads])
                       for c in cols}
            return Stream(name=name, t=t, payload=payload, scale_stamp=ss), 0
        with open(files[0], "rb") as f:
            members = _members_in_place(f)
            if members is not None:
                columns, mapped = _read_in_place(f, members)
        if members is None:
            with np.load(files[0], allow_pickle=False) as z:
                columns = {k: z[k] for k in z.files if _wanted(k)}
            mapped = 0
        return Stream(
            name=name, t=columns["__t__"],
            payload={k[2:]: v for k, v in columns.items()
                     if k.startswith("c:")},
            scale_stamp=columns.get("__scale_stamp__")), mapped

    def manifest(self, key: str) -> Dict:
        with open(self._dir(key) / _MANIFEST) as f:
            return json.load(f)

    def delete(self, key: str) -> None:
        d = self._dir(key)
        targets = [d / _COLUMNS, d / _MANIFEST]
        if d.exists():
            targets += [self._chunk_file(d, i) for i in self.list_chunks(key)]
        for p in targets:
            if p.exists():
                p.unlink()
        if d.exists() and not any(d.iterdir()):
            d.rmdir()

    # --------------------------------------------------------------- markers
    def _marker_dir(self, sweep_id: str) -> Path:
        """Marker namespace directory. ``sweep_id`` may nest
        (``"<sweep>/queue"``): each ``/``-separated segment must be
        non-empty and not dot-prefixed (dot-prefixed names are reserved
        for :meth:`clear_markers`'s invisible trash directories)."""
        segments = str(sweep_id).split("/")
        if not sweep_id or any(not s or s.startswith(".") or s == ".."
                               for s in segments):
            raise ValueError(f"bad sweep id {sweep_id!r}")
        return self.root.joinpath("_markers", *segments)

    @staticmethod
    def _marker_file(d: Path, name: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad marker name {name!r}")
        return d / f"{name}.json"

    def put_marker(self, sweep_id: str, name: str, payload: Dict, *,
                   exclusive: bool = False) -> bool:
        """Atomically persist one sweep completion marker (crash-safe:
        temp file + ``os.replace``, the stream-write discipline).

        ``exclusive=True`` switches to create-if-absent semantics
        (``os.link`` of the temp file onto the target — atomic on POSIX):
        when the marker already exists, nothing is written and False is
        returned. Exactly one of N concurrent exclusive writers wins,
        which is how the sweep service elects its work-queue publisher
        without a coordinator. Returns True when this call wrote the
        marker."""
        d = self._marker_dir(sweep_id)
        d.mkdir(parents=True, exist_ok=True)
        target = self._marker_file(d, name)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                # dumps-then-write, not json.dump: the streaming dump
                # path bypasses the C encoder and is ~10x slower on the
                # sweep service's large count-row payloads
                f.write(json.dumps(payload))
            if exclusive:
                try:
                    os.link(tmp, target)
                except FileExistsError:
                    return False
            else:
                os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True

    def get_marker(self, sweep_id: str, name: str) -> Dict:
        d = self._marker_dir(sweep_id)
        with open(self._marker_file(d, name)) as f:
            return json.load(f)

    def has_marker(self, sweep_id: str, name: str) -> bool:
        return self._marker_file(self._marker_dir(sweep_id), name).exists()

    def claim_marker(self, src_sweep_id: str, src_name: str,
                     dst_sweep_id: str, dst_name: str) -> bool:
        """Atomically MOVE a marker between namespaces (``os.replace``).

        The sweep service's lease primitive: renaming
        ``queue/<item>`` to ``leases/<item>`` both removes the item from
        the queue and records the claim in one filesystem-atomic step, so
        of N racing claimants exactly one succeeds — the others find the
        source gone and get False. The payload travels with the file;
        the winner typically rewrites it (e.g. with lease metadata)
        immediately after.
        """
        src = self._marker_file(self._marker_dir(src_sweep_id), src_name)
        d = self._marker_dir(dst_sweep_id)
        d.mkdir(parents=True, exist_ok=True)
        try:
            os.replace(src, self._marker_file(d, dst_name))
        except FileNotFoundError:
            return False
        return True

    def remove_marker(self, sweep_id: str, name: str) -> bool:
        """Delete one marker; False if it was already gone (losing this
        race is normal — e.g. a reaper removing a lease whose worker
        finished concurrently)."""
        try:
            self._marker_file(self._marker_dir(sweep_id), name).unlink()
        except FileNotFoundError:
            return False
        return True

    def marker_mtime(self, sweep_id: str, name: str) -> Optional[float]:
        """Last-modified wall time of a marker file, or None if missing
        (the reaper's fallback freshness signal for a lease claimed by a
        worker that died before writing its lease payload)."""
        try:
            return self._marker_file(self._marker_dir(sweep_id),
                                     name).stat().st_mtime
        except FileNotFoundError:
            return None

    def list_markers(self, sweep_id: str) -> List[str]:
        d = self._marker_dir(sweep_id)
        if not d.exists():
            return []
        return sorted(p.stem for p in d.iterdir()
                      if p.suffix == ".json")

    def clear_markers(self, sweep_id: str) -> None:
        """Remove the WHOLE ``_markers/<sweep_id>/`` namespace (including
        nested sub-namespaces) atomically: the directory is first renamed
        to an invisible dot-prefixed trash sibling (one ``os.rename``),
        then deleted. A concurrent host therefore observes the namespace
        either fully present or fully absent — never a half-cleared sweep
        whose surviving markers misread as "mostly fresh". Concurrent
        clears are safe: the losing rename finds the source gone and
        returns. A crash after the rename leaves only an invisible trash
        directory (``_marker_dir`` rejects dot-prefixed segments, and
        ``list_markers`` ignores non-``.json`` entries), swept by the
        next successful clear."""
        import shutil

        d = self._marker_dir(sweep_id)
        trash = d.parent / f".trash-{d.name}-{uuid.uuid4().hex[:8]}"
        try:
            os.rename(d, trash)
        except FileNotFoundError:
            pass
        else:
            shutil.rmtree(trash, ignore_errors=True)
        # opportunistic sweep of trash left by a crashed earlier clear
        if d.parent.exists():
            for p in d.parent.iterdir():
                if p.name.startswith(".trash-") and p.is_dir():
                    shutil.rmtree(p, ignore_errors=True)
