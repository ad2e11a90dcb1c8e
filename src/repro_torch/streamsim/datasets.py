"""Synthetic IoT stream datasets, statistically matched to the paper's three.

The container is offline, so the real SogouQ / Baidu-Traffic / Taobao
UserBehavior dumps cannot be downloaded. Each generator below produces a
seeded, *statistically matched* surrogate: a non-homogeneous Poisson arrival
process over one day (86 400 s) whose diurnal intensity curve is calibrated so
the per-second Average / Variance / StdVariance land in the magnitude range of
the paper's Tables 1-3:

  ============== ============ ============= =================
  dataset        avg (rec/s)  variance      paper table
  ============== ============ ============= =================
  SogouQ         ~25.4        ~235          Table 1
  Traffic        ~21.5        ~113          Table 2
  UserBehavior   ~122         ~4 545        Table 3
  ============== ============ ============= =================

Records carry the same field structure as the originals (query logs,
map queries, user-behavior tuples) so the POSD stage has real parsing work:
SogouQ carries "accurate time" strings (YYYY-MM-DD HH:MM:SS), UserBehavior
carries timestamps offset into a different time zone (the paper calls out
exactly this quirk), Traffic carries float epoch timestamps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

DAY = 86_400  # the paper's original time range, seconds

# UserBehavior timestamps are (per the paper) in a different time zone;
# we emulate UTC+0 storage of a UTC+8 stream.
USERBEHAVIOR_TZ_OFFSET = 8 * 3600


@dataclasses.dataclass(frozen=True)
class RawStream:
    """An unpreprocessed bounded stream B = s_1..s_n (paper Def. 2).

    ``columns`` maps field name -> 1-D np.ndarray, all of equal length, in
    arrival order. Exactly one column carries time information but it is NOT
    labelled as such — identifying it is POSD's job.
    """

    name: str
    columns: Dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))


def _smooth_noise(seconds: np.ndarray, scale_s: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Unit-variance noise correlated at timescale ``scale_s`` (linear
    interpolation of an i.i.d. grid — a cheap Ornstein-Uhlenbeck stand-in)."""
    knots = rng.standard_normal(int(DAY / scale_s) + 2)
    axis = np.arange(len(knots)) * scale_s
    x = np.interp(seconds, axis, knots)
    return (x - x.mean()) / (x.std() + 1e-9)


def _diurnal_intensity(name: str, rate: float, cv: float,
                       seconds: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """Per-second expected arrival rate with a realistic diurnal shape.

    Two activity peaks (late morning, evening), a deep overnight trough, and
    bursts correlated at multiple timescales — matching the "large
    fluctuation in the day" shape of the paper's Figs. 1-3.

    The shape is standardized and rescaled so the per-second count series has
    mean ``rate`` and coefficient of variation ``cv``: the calibration knobs
    that land each dataset in its Table 1-3 magnitude range. Multi-timescale
    correlation matters: NSA's time compression averages λ over
    ``T/max_range``-second windows, so only variance at slower timescales
    survives — exactly the paper's observation that simulated volatility
    tracks the original.
    """
    t = seconds / DAY  # [0, 1)
    # Trend: overnight trough + late-morning and evening peaks.
    trend = (
        0.35
        + 0.45 * np.exp(-0.5 * ((t - 0.45) / 0.13) ** 2)  # ~10:48 peak
        + 0.65 * np.exp(-0.5 * ((t - 0.85) / 0.09) ** 2)  # ~20:24 peak
        - 0.25 * np.exp(-0.5 * ((t - 0.17) / 0.10) ** 2)  # ~4:00 trough
    )
    shape = (
        (trend - trend.mean()) / (trend.std() + 1e-9)
        + 0.55 * _smooth_noise(seconds, 1800.0, rng)  # 30-min bursts
        + 0.30 * _smooth_noise(seconds, 240.0, rng)   # 4-min bursts
    )
    z = (shape - shape.mean()) / (shape.std() + 1e-9)
    return rate * np.clip(1.0 + cv * z, 0.01, None)


def _arrival_timestamps(intensity: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    """Sample a non-homogeneous Poisson process: per-second counts then
    uniform sub-second placement, returned sorted (chronological order,
    paper Def. 1)."""
    counts = rng.poisson(intensity)
    sec = np.repeat(np.arange(len(intensity), dtype=np.float64), counts)
    frac = rng.random(sec.shape[0])
    ts = sec + frac
    ts.sort(kind="stable")
    return ts


def sogouq(scale: float = 1.0, seed: int = 0) -> RawStream:
    """SogouQ-like search-engine query log (paper [9]).

    Fields: accurate-time string, anonymized user id, query hash, result
    rank, click rank. Time is an "accurate time" string — POSD must parse it.
    """
    rng = np.random.default_rng(seed + 11)
    seconds = np.arange(DAY)
    lam = _diurnal_intensity("sogouq", 25.4 * scale, 0.60, seconds, rng)
    ts = _arrival_timestamps(lam, rng)
    n = len(ts)
    base = np.datetime64("2008-06-01T00:00:00")
    times = base + (ts).astype("timedelta64[s]")
    time_str = np.datetime_as_string(times, unit="s")
    time_str = np.char.replace(time_str, "T", " ")
    return RawStream(
        name="sogouq",
        columns={
            "access_time": time_str,  # 'YYYY-MM-DD HH:MM:SS'
            "user_id": rng.integers(0, 2_000_000, n, dtype=np.int64),
            "query_hash": rng.integers(0, 2**31, n, dtype=np.int64),
            "result_rank": rng.integers(1, 11, n, dtype=np.int32),
            "click_rank": rng.integers(1, 11, n, dtype=np.int32),
        },
    )


def traffic(scale: float = 1.0, seed: int = 0) -> RawStream:
    """Baidu-Map query sub-dataset surrogate (paper [10]).

    Fields: float epoch timestamp, start/dest coordinates, estimated travel
    time. Beijing bounding box for coordinates.
    """
    rng = np.random.default_rng(seed + 22)
    seconds = np.arange(DAY)
    lam = _diurnal_intensity("traffic", 21.5 * scale, 0.49, seconds, rng)
    ts = _arrival_timestamps(lam, rng)
    n = len(ts)
    epoch0 = 1_491_004_800.0  # 2017-04-01 00:00:00 UTC
    return RawStream(
        name="traffic",
        columns={
            "query_ts": epoch0 + ts,  # float epoch seconds
            "start_lat": rng.uniform(39.44, 41.06, n),
            "start_lon": rng.uniform(115.42, 117.51, n),
            "dest_lat": rng.uniform(39.44, 41.06, n),
            "dest_lon": rng.uniform(115.42, 117.51, n),
            "eta_s": rng.gamma(2.0, 900.0, n).astype(np.float32),
        },
    )


def userbehavior(scale: float = 1.0, seed: int = 0) -> RawStream:
    """Taobao UserBehavior surrogate (paper [11]).

    Fields: user/item/category ids, behavior type, integer timestamp — stored
    in a shifted time zone (the paper's preprocessing call-out): POSD must
    normalize zones.
    """
    rng = np.random.default_rng(seed + 33)
    seconds = np.arange(DAY)
    lam = _diurnal_intensity("userbehavior", 122.0 * scale, 0.55, seconds, rng)
    ts = _arrival_timestamps(lam, rng)
    n = len(ts)
    behaviors = np.array([0, 1, 2, 3], dtype=np.int32)  # pv, buy, cart, fav
    epoch0 = 1_511_539_200  # 2017-11-25 00:00:00 UTC
    return RawStream(
        name="userbehavior",
        columns={
            "user_id": rng.integers(1, 1_000_000, n, dtype=np.int64),
            "item_id": rng.integers(1, 4_000_000, n, dtype=np.int64),
            "category_id": rng.integers(1, 9_500, n, dtype=np.int64),
            "behavior_type": rng.choice(behaviors, n, p=[0.89, 0.02, 0.06, 0.03]),
            # integer epoch seconds, but shifted: stored as UTC+8 wall clock
            "timestamp": (epoch0 + ts + USERBEHAVIOR_TZ_OFFSET).astype(np.int64),
        },
    )


DATASETS: Dict[str, Callable[..., RawStream]] = {
    "sogouq": sogouq,
    "traffic": traffic,
    "userbehavior": userbehavior,
}


def make_stream(name: str, scale: float = 1.0, seed: int = 0) -> RawStream:
    """Factory over the three paper datasets.

    ``scale`` < 1 shrinks the arrival rate proportionally (used by tests so
    full pipelines run in milliseconds while keeping the diurnal shape).
    """
    try:
        return DATASETS[name](scale=scale, seed=seed)
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
