"""The synthetic IoT streams of the benchmark, frozen.

A copy of the generators of ``repro_torch.streamsim.datasets`` as they
stood when the benchmark was written, so that the benchmark's inputs stay
the same whatever later changes make of the program's own generators.
What defines a deployment's stream comes from its configuration's
``datasets`` entry (``stream_bench/configs/<config>.json``): the record
schema, the mean rate and the coefficient of variation of the per-second
counts, the number of days, the first day's epoch second, the time column
and the zone it is stored in. What stays here is each schema's columns
and how they are drawn. :func:`make` returns the raw, unpreprocessed
stream as a dict of equal-length NumPy columns in arrival order; the
benchmark hands the same columns to the program and to the reference.

Plain NumPy; imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np

DAY = 86_400

Columns = Dict[str, np.ndarray]


def _smooth_noise(seconds: np.ndarray, scale_s: float,
                  rng: np.random.Generator) -> np.ndarray:
    knots = rng.standard_normal(int(len(seconds) / scale_s) + 2)
    axis = np.arange(len(knots)) * scale_s
    x = np.interp(seconds, axis, knots)
    return (x - x.mean()) / (x.std() + 1e-9)


def _diurnal_intensity(rate: float, cv: float, seconds: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    t = (seconds % DAY) / DAY
    trend = (
        0.35
        + 0.45 * np.exp(-0.5 * ((t - 0.45) / 0.13) ** 2)
        + 0.65 * np.exp(-0.5 * ((t - 0.85) / 0.09) ** 2)
        - 0.25 * np.exp(-0.5 * ((t - 0.17) / 0.10) ** 2)
    )
    shape = (
        (trend - trend.mean()) / (trend.std() + 1e-9)
        + 0.55 * _smooth_noise(seconds, 1800.0, rng)
        + 0.30 * _smooth_noise(seconds, 240.0, rng)
    )
    z = (shape - shape.mean()) / (shape.std() + 1e-9)
    return rate * np.clip(1.0 + cv * z, 0.01, None)


def _arrival_timestamps(intensity: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    counts = rng.poisson(intensity)
    sec = np.repeat(np.arange(len(intensity), dtype=np.float64), counts)
    frac = rng.random(sec.shape[0])
    ts = sec + frac
    ts.sort(kind="stable")
    return ts


def _arrivals(spec: Mapping, scale: float,
              rng: np.random.Generator) -> np.ndarray:
    """Arrival offsets in seconds from the first day's start."""
    seconds = np.arange(int(spec["days"]) * DAY)
    lam = _diurnal_intensity(float(spec["rate_per_s"]) * scale,
                             float(spec["cv"]), seconds, rng)
    return _arrival_timestamps(lam, rng)


def sogouq(spec: Mapping, scale: float, seed: int) -> Columns:
    """Search-engine query log; time as 'YYYY-MM-DD HH:MM:SS' strings."""
    rng = np.random.default_rng(seed + 11)
    ts = _arrivals(spec, scale, rng)
    n = len(ts)
    times = np.datetime64(int(spec["start_epoch_s"]), "s") + ts.astype(
        "timedelta64[s]")
    time_str = np.char.replace(np.datetime_as_string(times, unit="s"),
                               "T", " ")
    return {
        spec["time_column"]: time_str,
        "user_id": rng.integers(0, 2_000_000, n, dtype=np.int64),
        "query_hash": rng.integers(0, 2**31, n, dtype=np.int64),
        "result_rank": rng.integers(1, 11, n, dtype=np.int32),
        "click_rank": rng.integers(1, 11, n, dtype=np.int32),
    }


def traffic(spec: Mapping, scale: float, seed: int) -> Columns:
    """Map-query log; float epoch stamps."""
    rng = np.random.default_rng(seed + 22)
    ts = _arrivals(spec, scale, rng)
    n = len(ts)
    return {
        spec["time_column"]: float(spec["start_epoch_s"]) + ts,
        "start_lat": rng.uniform(39.44, 41.06, n),
        "start_lon": rng.uniform(115.42, 117.51, n),
        "dest_lat": rng.uniform(39.44, 41.06, n),
        "dest_lon": rng.uniform(115.42, 117.51, n),
        "eta_s": rng.gamma(2.0, 900.0, n).astype(np.float32),
    }


def userbehavior(spec: Mapping, scale: float, seed: int) -> Columns:
    """Shop user-behaviour log; integer stamps stored in the zone
    ``tz_offset_s`` east of UTC."""
    rng = np.random.default_rng(seed + 33)
    ts = _arrivals(spec, scale, rng)
    n = len(ts)
    behaviors = np.array([0, 1, 2, 3], dtype=np.int32)
    return {
        "user_id": rng.integers(1, 1_000_000, n, dtype=np.int64),
        "item_id": rng.integers(1, 4_000_000, n, dtype=np.int64),
        "category_id": rng.integers(1, 9_500, n, dtype=np.int64),
        "behavior_type": rng.choice(behaviors, n,
                                    p=[0.89, 0.02, 0.06, 0.03]),
        spec["time_column"]: (int(spec["start_epoch_s"]) + ts +
                              int(spec["tz_offset_s"])).astype(np.int64),
    }


#: record schema -> its generator
SCHEMAS: Dict[str, Callable[[Mapping, float, int], Columns]] = {
    "sogouq": sogouq,
    "traffic": traffic,
    "userbehavior": userbehavior,
}


def make(spec: Mapping, scale: float, seed: int) -> Columns:
    """The raw columns of the dataset that ``spec`` (a configuration's
    ``datasets`` entry) describes, at ``scale`` from ``seed``."""
    return SCHEMAS[spec["schema"]](spec, scale, seed)
