"""The plain reference of the stream simulator, in NumPy.

From the raw columns the set-up made, it works out again what the program
must produce (Chu, Du, Yu 2022): POSD (find the time column, parse it,
shift it to one zone), NSA (paper formula (1) and the per-bucket
systematic sample), the per-second counts and their Average / Variance /
Std (formulas (2)-(4)), the 60-second trend correlation of each simulated
stream with its original, and the Fig.-6 S×S trend-correlation matrix per
range. Every count is an exact integer and every statistic float64.

A source of N > 1 days (the configuration's datasets' ``days``) is
compressed into ``max_range`` seconds a day, ``max_range · N`` buckets, as
the program's multi-day sweep (``ScenarioSpec.span_s``) does: the sim, its
per-second counts and its statistics run over that span, and the report
and matrix keep the scenario's ``max_range`` as its name.

``low=True`` gives the control: the same steps one precision lower than the
configuration states, as a later change might be tempted to compute them:
the normalization in float32 (stated: float64) and every statistic in
bfloat16 (stated: float32), the prefix sums of the trends kept in
bfloat16 as the scan would store them, and the stored original's stamps as
float32 holds them (stated: float64). It must come out as not correct.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

Scenario = Tuple[str, int]


def bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


# -------------------------------------------------------------------- POSD
def _days_from_civil(y, m, d):
    """Days since 1970-01-01 of a proleptic Gregorian date (vectorized)."""
    y = y - (m <= 2)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    doy = (153 * (m + np.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def parse_datetimes(col: np.ndarray) -> np.ndarray:
    """'YYYY-MM-DD HH:MM:SS' strings -> float64 epoch seconds (UTC)."""
    chars = np.ascontiguousarray(col.astype("<U19"))
    cp = chars.view(np.uint32).reshape(len(chars), 19).astype(np.int64) - 48

    def num(a, b):
        out = np.zeros(len(cp), np.int64)
        for j in range(a, b):
            out = out * 10 + cp[:, j]
        return out

    days = _days_from_civil(num(0, 4), num(5, 7), num(8, 10))
    secs = days * 86_400 + num(11, 13) * 3600 + num(14, 16) * 60 + \
        num(17, 19)
    return secs.astype(np.float64)


def posd(columns: Dict[str, np.ndarray], time_column: str,
         tz_offset_s: float) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The preprocessed stream: float64 stamps in one zone, sorted, and the
    other columns in their order."""
    col = columns[time_column]
    t = parse_datetimes(col) if col.dtype.kind in "US" else \
        col.astype(np.float64)
    if tz_offset_s:
        t = t - float(tz_offset_s)
    payload = {k: v for k, v in columns.items() if k != time_column}
    if len(t) > 1 and np.any(t[1:] < t[:-1]):
        order = np.argsort(t, kind="stable")
        t = t[order]
        payload = {k: v[order] for k, v in payload.items()}
    return t, payload


# --------------------------------------------------------------------- NSA
def scale_stamps(t: np.ndarray, max_range: int, low: bool = False):
    """Paper formula (1): floor((t - t_min) / (t_max - t_min) * max)."""
    span = float(t[-1] - t[0]) if len(t) else 0.0
    if span <= 0.0:
        return np.zeros(len(t), np.int64)
    if low:
        x = (t - t[0]).astype(np.float32)
        ss = np.floor(x / np.float32(span) * np.float32(max_range))
    else:
        ss = np.floor((t - t[0]) / span * max_range)
    return np.clip(ss.astype(np.int64), 0, max_range - 1)


def nsa(t: np.ndarray, payload: Dict[str, np.ndarray], max_range: int,
        low: bool = False) -> Dict[str, np.ndarray]:
    """One simulated stream: the kept records' ``t``, ``scale_stamp`` and
    payload columns. Bucket ``b`` of ``c`` records keeps
    ``k = max(rint(c / multiple), 1)`` of them, the record of rank ``r``
    iff ``(r * k) mod c < k``, with ``multiple = max(span / max, 1)``."""
    ss = scale_stamps(t, max_range, low)
    span = float(t[-1] - t[0]) if len(t) else 0.0
    multiple = max(span / max_range, 1.0)
    c = np.bincount(ss, minlength=max_range)
    first = np.searchsorted(ss, np.arange(max_range))
    rank = np.arange(len(ss)) - first[ss]
    if low:
        k = np.rint(c.astype(np.float32) / np.float32(multiple))
    else:
        k = np.rint(c / multiple)
    k = np.maximum(k.astype(np.int64), 1)
    keep = (rank * k[ss]) % c[ss] < k[ss]
    sim = {"t": t[keep], "scale_stamp": ss[keep]}
    sim.update({k2: v[keep] for k2, v in payload.items()})
    return sim


# -------------------------------------------------------------- statistics
def original_counts(t: np.ndarray) -> np.ndarray:
    """Records in each second since the first record."""
    b = np.floor(t - t[0]).astype(np.int64)
    return np.bincount(b, minlength=int(b.max()) + 1)


def volatility(q: np.ndarray, tr: int, low: bool = False):
    """(Average, Variance, Std) of the per-second counts over ``tr`` s."""
    if not low:
        s = int(q.sum())
        s2 = int((q.astype(np.int64) ** 2).sum())
        avg = s / tr
        var = max(s2 / tr - avg * avg, 0.0)
        return avg, var, float(np.sqrt(var))
    qb = bf16(q).astype(np.float32)
    s = float(bf16(qb.sum(dtype=np.float32)))
    s2 = float(bf16(bf16(qb * qb).astype(np.float32).sum(dtype=np.float32)))
    avg = float(bf16(s / tr))
    var = float(bf16(max(float(bf16(s2 / tr)) - float(bf16(avg * avg)),
                         0.0)))
    return avg, var, float(bf16(np.sqrt(var)))


def sliding_mean(q: np.ndarray, window: int, low: bool = False):
    """Mean over the ``w``-second window centred as numpy's 'same'
    convolution centres it, zero past the ends, ``w = clip(window, 1, n)``."""
    n = len(q)
    w = max(min(window, n), 1)
    half = (w - 1) // 2
    c = np.concatenate([[0], np.cumsum(q, dtype=np.int64)])
    i = np.arange(n)
    hi = np.minimum(i + half + 1, n)
    lo = np.maximum(i + half + 1 - w, 0)
    if low:
        c = bf16(c)
        return bf16(bf16(c[hi] - c[lo]) / w)
    return (c[hi] - c[lo]) / w


def resample(x: np.ndarray, k: int, low: bool = False) -> np.ndarray:
    """Linear interpolation of ``x`` at ``i * (n - 1) / (k - 1)``."""
    n = len(x)
    pos = np.arange(k) * ((n - 1) / max(k - 1, 1))
    j = np.clip(np.floor(pos).astype(np.int64), 0, max(n - 2, 0))
    frac = pos - j
    x1 = x[np.minimum(j + 1, n - 1)]
    if low:
        return bf16(bf16(x[j] * (1.0 - frac)) + bf16(x1 * frac))
    return x[j] * (1.0 - frac) + x1 * frac


def _centred(x: np.ndarray, low: bool) -> np.ndarray:
    if low:
        return bf16(x - bf16(x.astype(np.float32).mean(dtype=np.float32)))
    return x - x.mean()


def _gram(z: np.ndarray, low: bool) -> np.ndarray:
    if low:
        z32 = z.astype(np.float32)
        return bf16(z32 @ z32.T)
    return z @ z.T


def trend_corr(qa: np.ndarray, qb: np.ndarray, window: int,
               low: bool = False) -> float:
    """Pearson r of two count series' trends, both resampled to the
    shorter one's length (the per-report trend correlation)."""
    ta, tb = sliding_mean(qa, window, low), sliding_mean(qb, window, low)
    if not len(ta) or not len(tb):
        return float("nan")
    n = min(len(ta), len(tb))
    z = np.stack([_centred(resample(ta, n, low), low),
                  _centred(resample(tb, n, low), low)])
    g = _gram(z, low)
    den = np.sqrt(g[0, 0] * g[1, 1])
    return float(g[0, 1] / den) if den > 0 else float("nan")


def corr_matrix(counts: Sequence[np.ndarray], window: int,
                low: bool = False) -> np.ndarray:
    """The S×S Pearson matrix of the rows' trends on a common grid of the
    shortest row's length: symmetric, clipped to [-1, 1], unit diagonal,
    NaN rows and columns for empty or flat series."""
    trends = [sliding_mean(np.asarray(q), window, low) for q in counts]
    S = len(trends)
    out = np.full((S, S), np.nan)
    live = [s for s in range(S) if len(trends[s])]
    if not live:
        return out
    k = min(len(trends[s]) for s in live)
    z = np.stack([_centred(resample(trends[s], k, low), low) for s in live])
    g = _gram(z, low)
    g = (g + g.T) / 2.0
    d = np.sqrt(np.clip(np.diag(g), 0.0, None))
    den = np.outer(d, d)
    with np.errstate(invalid="ignore", divide="ignore"):
        sub = np.where(den > 0, g / np.where(den > 0, den, 1.0), np.nan)
    sub = np.clip(sub, -1.0, 1.0)
    np.fill_diagonal(sub, np.where(d > 0, 1.0, np.nan))
    out[np.ix_(live, live)] = sub
    return out


# ------------------------------------------------------------------ a cell
@dataclasses.dataclass
class Expected:
    """What one job of a cell must produce."""

    scenarios: List[Scenario]
    #: scenario -> the simulated stream's columns (``t``, ``scale_stamp``,
    #: payload)
    sims: Dict[Scenario, Dict[str, np.ndarray]]
    #: scenario -> per-second counts of the simulated stream
    sim_counts: Dict[Scenario, np.ndarray]
    #: scenario -> the report's fields
    reports: Dict[Scenario, Dict]
    #: max_range -> (labels, S×S matrix), for entries that give matrices
    fidelity: Dict[int, Tuple[List[str], np.ndarray]]
    #: dataset -> the original as POSD stores it (``t`` and the payload
    #: columns)
    originals: Dict[str, Dict[str, np.ndarray]]


def expected(raw: Dict[str, Dict[str, np.ndarray]], config: Dict,
             max_ranges: Sequence[int], low: bool = False) -> Expected:
    """Work out a job's outputs from the raw columns of every dataset.

    ``config`` is the configuration's JSON (``datasets`` with each one's
    ``time_column``, ``tz_offset_s`` and ``days``, ``knobs.
    fidelity_window_s``, ``report_window_s``, ``entry``)."""
    datasets = list(config["datasets"])
    n_days = max(int(s.get("days", 1)) for s in config["datasets"].values())
    win = int(config["report_window_s"])
    fid_win = int(config["knobs"].get("fidelity_window_s", win))
    scenarios = [(d, int(mr)) for d in datasets for mr in max_ranges]
    sims, sim_counts, reports = {}, {}, {}
    orig, originals = {}, {}
    for d in datasets:
        spec = config["datasets"][d]
        t, payload = posd(raw[d], spec["time_column"], spec["tz_offset_s"])
        q = original_counts(t)
        orig[d] = (t, payload, q, volatility(q, len(q), low))
        stored = t.astype(np.float32).astype(np.float64) if low else t
        originals[d] = {"t": stored, **payload}
    for d, mr in scenarios:
        t, payload, q, vol = orig[d]
        span = mr * n_days
        sim = nsa(t, payload, span, low)
        qs = np.bincount(sim["scale_stamp"], minlength=span)
        sims[(d, mr)], sim_counts[(d, mr)] = sim, qs
        reports[(d, mr)] = {
            "original_rows": len(t),
            "simulated_rows": len(sim["t"]),
            "original_volatility": vol + (len(q),),
            "simulated_volatility": volatility(qs, span, low) + (span,),
            "trend_corr": trend_corr(q, qs, win, low),
        }
    fidelity = {}
    if config["entry"] == "run_many":
        for mr in max_ranges:
            labels = [f"{d}/original" for d in datasets] + \
                [f"{d}/sim{mr}" for d in datasets]
            rows = [orig[d][2] for d in datasets] + \
                [sim_counts[(d, mr)] for d in datasets]
            fidelity[int(mr)] = (labels, corr_matrix(rows, fid_win, low))
    return Expected(scenarios, sims, sim_counts, reports, fidelity, originals)

