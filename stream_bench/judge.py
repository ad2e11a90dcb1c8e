"""The comparison that decides ``correct``.

Each job's outputs are set beside the plain reference's
(:func:`stream_bench.reference.simulate.expected`), and the numbers
below come out, each held to the limit the configuration gives it:

- ``sims_bad``: simulated records read back from the job's store (kept
  stamps, scale stamps, every payload column, with their types) that are
  not the reference's, record for record; a missing or extra record counts.
  A stored stream is the files its manifest names, in order: its chunk
  files where it was stored chunk by chunk, else its ``columns.npz``.
- ``replay_bad``: buckets the consumer got whose stamp or record count is
  not the reference's, plus delivered records that are not the
  reference's, in order.
- ``rows_bad``: report fields that must be exact and are not (records in
  and kept, the series' lengths, a missing report or matrix, a report
  not ``ok``, a matrix's labels).
- ``vol_rel``: the largest relative gap of an Average, Variance or Std of
  a report from the reference's float64 value.
- ``trend_gap``: the largest gap of a report's trend correlation.
- ``fidelity_gap``: the largest gap of an entry of a fidelity matrix.
- ``feed_hwm``, where the configuration's limits name it (a chunked
  deployment): the most chunks of a scenario the replay's feed held on
  the host at once, the largest over every report of every job; a report
  without the program's ``feed_hwm_chunks`` reads as over any limit.
- ``orig_bad``, where the job ran POSD itself (a traffic mix with
  ``"posd": true``): records of the originals the job stored (``t`` and
  every payload column, with their types) that are not the reference's
  POSD, record for record; a missing or extra record counts. NSA keeps a
  few records of a day, so ``sims_bad`` alone would not see a wrong
  payload in one it drops.

A job that kept its records and stored streams whole is compared record
for record. A later job that kept only digests (of its stored streams
whole, of the records of a sample of buckets drawn from the seed) counts
what the last whole job counted where its digests are that job's, and
every record of the scenario (or original) where they are not. Bucket
stamps and counts, reports and matrices are compared for every job.
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

Scenario = Tuple[str, int]

#: store file name of a column of the on-disk format
_STORE_KEYS = {"t": "__t__", "scale_stamp": "__scale_stamp__"}


@dataclasses.dataclass
class JobOutput:
    """What one job produced, in the reference's terms."""

    #: scenario -> the report's fields, as in ``Expected.reports``, and its
    #: feed's ``feed_hwm`` (None where the report has none)
    reports: Dict[Scenario, Dict]
    #: max_range -> (labels, matrix)
    fidelity: Dict[int, Tuple[List[str], np.ndarray]]
    #: scenario -> what the consumer got: {"stamps", "counts"} of its
    #: buckets, the "digest" of a sample of their records and, where the
    #: job is checked whole, the records' "columns" (else None)
    replay: Dict[Scenario, Dict]
    #: scenario -> the :func:`npz_digest` of each of the stored simulated
    #: stream's files, in order, or None where nothing was stored
    stored_digest: Dict[Scenario, Optional[tuple]]
    #: scenario -> the stored simulated stream's columns (None where
    #: nothing was stored), where the job is checked whole
    stored: Optional[Dict[Scenario, Optional[Dict[str, np.ndarray]]]] = None
    failed: bool = False
    #: dataset -> the :func:`npz_digest` of each of the original's files,
    #: as the job stored it (None where nothing was stored), where the job
    #: ran POSD itself; else None
    orig_digest: Optional[Dict[str, Optional[tuple]]] = None
    #: dataset -> the stored original's columns (None where nothing was
    #: stored), where the job ran POSD itself and is checked whole
    orig: Optional[Dict[str, Optional[Dict[str, np.ndarray]]]] = None


def output_of(exp, feed_hwm: Optional[int] = None) -> JobOutput:
    """The outputs of a job that produced exactly ``exp`` (an
    ``Expected``), whole: what the control hands the comparison. The
    reference holds no chunks on a feed: its reports carry ``feed_hwm``
    only where it is given."""
    reports = {sc: dict(r, status="ok", feed_hwm=feed_hwm)
               for sc, r in exp.reports.items()}
    replay = {}
    for sc, sim in exp.sims.items():
        stamps, counts = np.unique(sim["scale_stamp"], return_counts=True)
        replay[sc] = {"stamps": stamps, "counts": counts, "digest": None,
                      "columns": {k: v for k, v in sim.items()
                                  if k != "scale_stamp"}}
    return JobOutput(reports, dict(exp.fidelity), replay,
                     {sc: None for sc in exp.sims}, dict(exp.sims),
                     orig_digest=dict.fromkeys(exp.originals),
                     orig=dict(exp.originals))


def stored_files(stream_dir: Path) -> Optional[List[Path]]:
    """The files of a stored stream, in order, as its ``manifest.json``
    names them: ``columns.00000.npz`` ... where it has ``"chunks"``, else
    ``columns.npz``. None where there is no manifest or a file it names is
    missing: the store cannot read the stream back."""
    try:
        with open(stream_dir / "manifest.json") as f:
            chunks = int(json.load(f).get("chunks", 0))
    except FileNotFoundError:
        return None
    files = [stream_dir / f"columns.{i:05d}.npz" for i in range(chunks)] \
        or [stream_dir / "columns.npz"]
    return files if all(p.exists() for p in files) else None


def npz_digest(path) -> tuple:
    """Each member of a stored ``columns.npz`` by name, CRC-32 and size, as
    its zip directory records them: equal for equal arrays, whatever the
    time the file was written."""
    with zipfile.ZipFile(path) as z:
        return tuple(sorted((i.filename, i.CRC, i.file_size)
                            for i in z.infolist()))


def load_stored(files: Sequence) -> Dict[str, np.ndarray]:
    """A simulated stream as the store wrote it: the columns of its files
    (:func:`stored_files`), concatenated in order."""
    inv = {v: k for k, v in _STORE_KEYS.items()}
    parts = []
    for path in files:
        with np.load(path, allow_pickle=False) as z:
            parts.append({inv.get(k, k[2:] if k.startswith("c:") else k):
                          z[k] for k in z.files})
    return {k: np.concatenate([p[k] for p in parts if k in p])
            for k in set().union(*parts)}


def records_bad(got: Optional[Dict[str, np.ndarray]],
                want: Dict[str, np.ndarray]) -> int:
    """Records of ``got`` that differ from ``want`` in any column (a column
    missing, extra, of another type or of another length spoils every
    record)."""
    n_want = len(want["t"])
    if got is None:
        return n_want
    n_got = len(got["t"]) if "t" in got else 0
    if set(got) != set(want) or any(got[k].dtype != want[k].dtype or
                                    len(got[k]) != n_got for k in want):
        return max(n_got, n_want)
    n = min(n_got, n_want)
    bad = np.zeros(n, bool)
    for k, w in want.items():
        bad |= got[k][:n] != w[:n]
    return int(bad.sum()) + abs(n_got - n_want)


def _gap(a: float, b: float) -> float:
    if np.isnan(a) and np.isnan(b):
        return 0.0
    if np.isnan(a) or np.isnan(b):
        return float("inf")
    return abs(float(a) - float(b))


def _rel(got: float, want: float) -> float:
    g = _gap(got, want)
    return g / abs(want) if want else g


def numbers(expected, outputs: Iterable[JobOutput], feed: bool = False,
            posd: bool = False) -> Tuple[Dict[str, float], int, int]:
    """The numbers over every job of the window (``feed_hwm`` with
    ``feed``, ``orig_bad`` with ``posd``), the jobs, and of them the failed
    ones. ``outputs`` may be a generator: one job's outputs at a time are
    held."""
    n = {"sims_bad": 0, "replay_bad": 0, "rows_bad": 0, "vol_rel": 0.0,
         "trend_gap": 0.0}
    if expected.fidelity:
        n["fidelity_gap"] = 0.0
    if feed:
        n["feed_hwm"] = 0
    if posd:
        n["orig_bad"] = 0
    #: (kind, scenario) -> (digest, records bad) of the last whole job
    whole: Dict[Tuple[str, Scenario], Tuple[object, int]] = {}
    jobs = failed = 0
    for out in outputs:
        jobs += 1
        failed += out.failed
        for d, want_orig in (expected.originals.items() if posd else ()):
            digest = (out.orig_digest or {}).get(d)
            got = None if out.orig is None else (out.orig.get(d),)
            n["orig_bad"] += _records_bad(whole, ("orig", d), digest, got,
                                          want_orig)
        for sc in expected.scenarios:
            want_sim = expected.sims[sc]
            stored = None if out.stored is None else (out.stored.get(sc),)
            n["sims_bad"] += _records_bad(
                whole, ("stored", sc), out.stored_digest.get(sc), stored,
                want_sim)
            n["replay_bad"] += _replay_bad(whole, sc, out.replay.get(sc),
                                           want_sim)
            rep, want = out.reports.get(sc), expected.reports[sc]
            if feed and rep is not None:
                hwm = rep.get("feed_hwm")
                n["feed_hwm"] = max(n["feed_hwm"], float("inf")
                                    if hwm is None else hwm)
            if rep is None or rep.get("status", "ok") != "ok":
                n["rows_bad"] += 1
                continue
            for f in ("original_rows", "simulated_rows"):
                n["rows_bad"] += int(rep[f] != want[f])
            for f in ("original_volatility", "simulated_volatility"):
                got, w = rep[f], want[f]
                n["rows_bad"] += int(got[3] != w[3])
                n["vol_rel"] = max([n["vol_rel"]] +
                                   [_rel(got[i], w[i]) for i in range(3)])
            n["trend_gap"] = max(n["trend_gap"],
                                 _gap(rep["trend_corr"], want["trend_corr"]))
        for mr, (labels, want) in expected.fidelity.items():
            got = out.fidelity.get(mr)
            if got is None or list(got[0]) != labels or \
                    np.shape(got[1]) != want.shape:
                n["rows_bad"] += 1
                continue
            g = np.asarray(got[1], np.float64)
            both = np.isnan(g) & np.isnan(want)
            diff = np.where(both, 0.0, np.abs(g - want))
            n["fidelity_gap"] = max(n["fidelity_gap"],
                                    float(np.nan_to_num(diff, nan=np.inf)
                                          .max(initial=0.0)))
    return n, jobs, failed


def _records_bad(whole, key, digest, got, want: Dict[str, np.ndarray]) -> int:
    """Records bad of one output: ``got`` is ``(columns,)`` where the job
    kept them whole (its count is remembered with its digest), else None
    (the whole job's count where the digests agree, else all)."""
    if got is not None:
        bad = records_bad(got[0], want)
        whole[key] = (digest, bad)
        return bad
    seen = whole.get(key)
    if seen is not None and digest is not None and digest == seen[0]:
        return seen[1]
    return len(want["t"])


def _replay_bad(whole, sc, got: Optional[Dict],
                want_sim: Dict[str, np.ndarray]) -> int:
    if got is None:
        return len(want_sim["t"])
    stamps, counts = np.unique(want_sim["scale_stamp"], return_counts=True)
    g_st, g_ct = np.asarray(got["stamps"]), np.asarray(got["counts"])
    n = min(len(g_st), len(stamps))
    bad = int(np.sum((g_st[:n] != stamps[:n]) | (g_ct[:n] != counts[:n])))
    bad += abs(len(g_st) - len(stamps))
    cols = {k: v for k, v in want_sim.items() if k != "scale_stamp"}
    whole_cols = got.get("columns")
    return bad + _records_bad(
        whole, ("replay", sc), got.get("digest"),
        None if whole_cols is None else (whole_cols,), cols)


def judge(expected, outputs: Iterable[JobOutput], limits: Dict[str, float],
          posd: bool = False) -> Tuple[bool, Dict[str, Dict]]:
    """``(correct, {number: {"value", "limit"}})``: correct when there were
    jobs, none failed, and every number is within its limit. ``posd``: the
    jobs ran POSD themselves, and their stored originals are compared."""
    got, jobs, failed = numbers(expected, outputs, "feed_hwm" in limits,
                                posd)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    ok = jobs > 0 and not failed and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
