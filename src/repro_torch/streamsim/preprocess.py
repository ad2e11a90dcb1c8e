"""POSD — Preprocessing Original Stream Data (paper §3.1).

Jobs, per the paper:
  1. *identify* the field that carries time information (timestamp or
     "accurate time" ``YYYY-MM-DD HH:MM:SS``),
  2. convert accurate-time strings to timestamps,
  3. unify time zones (the UserBehavior quirk),
  4. persist the result — preprocessing is a one-time job, so the cleaned
     stream goes to the store ("database").

Everything is vectorized numpy; the output is a :class:`Stream` whose
``t`` array is float64 epoch-seconds, guaranteed non-decreasing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.streamsim.datasets import RawStream, USERBEHAVIOR_TZ_OFFSET

# Heuristic vocabulary for time-column identification.
_TIME_HINTS = ("time", "timestamp", "ts", "date")


@dataclasses.dataclass
class Stream:
    """A preprocessed bounded stream: tuples <X_i, t_i> (paper Def. 2).

    ``t``       : float64 epoch-seconds, non-decreasing (chronological order).
    ``payload`` : remaining record fields (the X_i), aligned with ``t``.
    ``scale_stamp`` : filled in by NSA (None until then).
    """

    name: str
    t: np.ndarray
    payload: Dict[str, np.ndarray]
    scale_stamp: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.t)

    @property
    def time_range(self) -> float:
        """Original time range of the stream in seconds (paper: 86 400)."""
        if len(self.t) == 0:
            return 0.0
        return float(self.t[-1] - self.t[0])

    def nbytes(self) -> int:
        n = self.t.nbytes + sum(v.nbytes for v in self.payload.values())
        if self.scale_stamp is not None:
            n += self.scale_stamp.nbytes
        return n


def identify_time_column(columns: Dict[str, np.ndarray]) -> str:
    """Find the column carrying time information.

    Preference order: (1) name contains a time hint AND parses as time,
    (2) any column that parses as an accurate-time string, (3) any monotone
    non-decreasing numeric column spanning a plausible epoch range.
    """
    hinted = [c for c in columns if any(h in c.lower() for h in _TIME_HINTS)]
    for name in hinted + [c for c in columns if c not in hinted]:
        col = columns[name]
        if _parses_as_time(col):
            return name
    raise ValueError(
        "no time column found — the framework requires streams to carry a "
        "timestamp or accurate time (paper advantage (2): universality)")


def _parses_as_time(col: np.ndarray) -> bool:
    head = col[: min(len(col), 64)]
    if col.dtype.kind in "US":  # accurate-time strings
        try:
            np.array(np.char.replace(head.astype(str), " ", "T"),
                     dtype="datetime64[s]")
            return True
        except ValueError:
            return False
    if col.dtype.kind in "if":
        # plausible epoch seconds (year ~1990..2100) and non-decreasing head
        h = head.astype(np.float64)
        if len(h) == 0:
            return False
        in_epoch = np.all((h > 6.0e8) & (h < 4.2e9))
        return bool(in_epoch and np.all(np.diff(h) >= 0))
    return False


def to_epoch_seconds(col: np.ndarray) -> np.ndarray:
    """Convert a time column (strings or numerics) to float64 epoch seconds."""
    if col.dtype.kind in "US":
        iso = np.char.replace(col.astype(str), " ", "T")
        dt = np.array(iso, dtype="datetime64[s]")
        return dt.astype("int64").astype(np.float64)
    return col.astype(np.float64)


def unify_timezone(t: np.ndarray, *, tz_offset_s: float = 0.0) -> np.ndarray:
    """Shift timestamps recorded in a non-reference zone back to reference.

    The paper: "some stream data use timestamps in different time zones such
    as UserBehavior, which requires timestamps using different time zones to
    be converted into the ones that using the same time zone."
    """
    if tz_offset_s == 0.0:
        return t
    return t - tz_offset_s


# Known per-dataset zone offsets (would be config/metadata in production).
_TZ_OFFSETS = {"userbehavior": float(USERBEHAVIOR_TZ_OFFSET)}


def preprocess(raw: RawStream, *, tz_offset_s: Optional[float] = None,
               sort_if_needed: bool = True) -> Stream:
    """Run POSD over a raw stream: identify + parse + zone-unify (+ sort).

    Sorting is a guard: real logs are chronological by construction
    (paper Def. 1) but the framework verifies rather than trusts.
    """
    time_col = identify_time_column(raw.columns)
    t = to_epoch_seconds(raw.columns[time_col])
    if tz_offset_s is None:
        tz_offset_s = _TZ_OFFSETS.get(raw.name, 0.0)
    t = unify_timezone(t, tz_offset_s=tz_offset_s)
    payload = {k: v for k, v in raw.columns.items() if k != time_col}
    if sort_if_needed and len(t) > 1 and np.any(np.diff(t) < 0):
        order = np.argsort(t, kind="stable")
        t = t[order]
        payload = {k: v[order] for k, v in payload.items()}
    return Stream(name=raw.name, t=t, payload=payload)
