"""Shape-keyed tile tuning for the port's kernels.

Counterpart of ``repro/kernels/tuning.py``, with every name of its
``__all__``. A :class:`TileConfig` ``(record_tile, bucket_block,
grid_split)`` chooses, on a CUDA device, a compile-time instance of a
kernel family (each built into its own library by
:mod:`repro_torch.kernels._build` with ``-D`` macros):

- ``stream_sample`` (B1): ``record_tile`` records a block, 1024, 2048 or
  4096 (``stream_sample.RECORD_TILES``); ``grid_split`` splits the batch
  rows of ``ops.stream_sample_batched`` into that many launches;
- ``compact`` (B2): ``record_tile`` records a tile, 4096, 8192 or 16384;
- ``metrics_fused`` (B3, B6): ``record_tile`` 2048, 4096 or 8192 records a
  tile times ``bucket_block`` 256, 512 or 1024 buckets a moment partial;
- ``trend_scan`` (B4, B7): ``record_tile`` 1024, 2048 or 4096 entries a
  tile;
- ``pair_stats`` (B5): ``bucket_block`` 256, 512 or 1024, the time quantum
  the ops layer pads to and the plan's split floor (a runtime parameter,
  no new library).

``record_tile`` changes no output: the ops layer pads the record axis to
``TILE = 1024`` whatever the config, and the kernels handle ragged tails.
``bucket_block`` changes the moments (and B5's sums) in their last bits;
the plain versions take the same ``bucket_block``. B8 (``flash_decode``)
is not tuned, as the reference's ``KERNELS`` leaves it out.

This module decides which config a dispatch gets:

1. **Heuristic** (``autotune="off"``, the default): a pure function of the
   :class:`TuneKey` and the device kind, with no I/O. On a CUDA card it
   returns the constants the port's kernels shipped with (B2's tile chosen
   from the unsnapped shape and the SM count, as the default library
   does), so ``"off"`` launches exactly the default libraries' instances;
   on the CPU (the plain versions) it returns :data:`DEFAULT_CONFIG`, as
   the reference does off its accelerators.
2. **Measured sweep** (``"cached"`` / ``"force"``): the candidate lattice
   (the heuristic config plus the family's instances no wider than the
   problem) is built in parallel, run once against the plain PyTorch
   version on the same device (a candidate that does not match is
   dropped), timed (min of ``reps``) and the fastest persisted under the
   store, one JSON marker per device kind:
   ``_markers/_tune/<kind>.json`` = ``{"version": 1, "device_kind",
   "entries": {<TuneKey.encode()>: <TileConfig.as_dict()>}}``, the
   reference's format byte for byte. ``"cached"`` reuses persisted
   winners; ``"force"`` re-measures once per key and process.

Unlike the reference, each tuner keeps, per key it swept, what every
candidate did (:attr:`KernelTuner.records`): its time, or why it was
dropped (did not match, failed to build, failed to launch). A sweep in
which every candidate fails returns the heuristic config (another CUDA
instance on a card, never the plain version for a CUDA tensor).

The ops wrappers consult the ambient tuner (:func:`config_for`) at every
dispatch, passing the dispatch device; the layers above install a shared
tuner with :func:`tuner_context` around their device legs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import compact as _compact
from repro_torch.kernels import metrics_fused as _metrics
from repro_torch.kernels import stream_sample as _sample
from repro_torch.kernels import trend_scan as _trend

LANE = 128
#: the reference's record-tile quantum (8 sublanes x 128 lanes); every
#: record tile is a multiple of it
MIN_RECORD_TILE = 8 * LANE

DEFAULT_RECORD_TILE = MIN_RECORD_TILE       # 1024 -- the ops layer's TILE
DEFAULT_BUCKET_BLOCK = 4 * LANE             # 512 -- BUCKET_BLOCK/PAIR_TILE

#: the reference's TPU footprint budget, kept for its API; the port's
#: candidates are its compiled instances, which no budget filters
VMEM_BUDGET_BYTES = 8 * 1024 * 1024

#: kernel families a TileConfig can parameterize (TuneKey.kernel values)
KERNELS = ("stream_sample", "metrics_fused", "trend_scan", "pair_stats",
           "compact")

AUTOTUNE_MODES = ("off", "cached", "force")

#: store marker namespace holding the per-device-kind JSON caches
TUNE_NAMESPACE = "_tune"

#: the device kind of the plain PyTorch versions (CPU tensors)
CPU_KIND = "cpu-plain"

#: SMs assumed for the B2 heuristic where no card can be asked (an H100
#: SXM's; only a fake GPU kind on a machine without one reaches it)
DEFAULT_SMS = 132


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One kernel tiling choice: ``(record_tile, bucket_block, grid_split)``.

    record_tile  : records (or time steps) a block or tile takes; a
                   positive multiple of ``MIN_RECORD_TILE`` (= 1024).
    bucket_block : buckets a moment partial (B3, B6) or the pair-stats
                   time quantum (B5); a positive multiple of ``LANE``.
    grid_split   : launches the batch rows of the NSA dispatch are split
                   into (``1`` = one launch).

    Frozen and hashable; a wrapper maps it to its family's instance and
    raises for a tile the family was not built with.
    """

    record_tile: int = DEFAULT_RECORD_TILE
    bucket_block: int = DEFAULT_BUCKET_BLOCK
    grid_split: int = 1

    def __post_init__(self):
        if self.record_tile <= 0 or self.record_tile % MIN_RECORD_TILE:
            raise ValueError(
                f"record_tile {self.record_tile} must be a positive "
                f"multiple of {MIN_RECORD_TILE}")
        if self.bucket_block <= 0 or self.bucket_block % LANE:
            raise ValueError(
                f"bucket_block {self.bucket_block} must be a positive "
                f"multiple of {LANE}")
        if self.grid_split < 1:
            raise ValueError(f"grid_split {self.grid_split} must be >= 1")

    @property
    def sublane(self) -> int:
        """``record_tile`` in units of ``LANE`` (the reference's block
        height)."""
        return self.record_tile // LANE

    def vmem_bytes(self, itemsize: int = 4) -> int:
        """The reference's footprint measure: a ``(record_tile,
        bucket_block)`` tile of ``itemsize`` bytes."""
        return self.record_tile * self.bucket_block * itemsize

    def as_dict(self) -> Dict[str, int]:
        return {"record_tile": self.record_tile,
                "bucket_block": self.bucket_block,
                "grid_split": self.grid_split}

    @classmethod
    def from_dict(cls, d: Dict) -> "TileConfig":
        return cls(record_tile=int(d["record_tile"]),
                   bucket_block=int(d["bucket_block"]),
                   grid_split=int(d.get("grid_split", 1)))


DEFAULT_CONFIG = TileConfig()


def _pow2_snap(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """Cache key for one tuning decision: the kernel family, the
    power-of-two-snapped stream count ``s``, record or time axis ``n`` and
    bucket axis ``r`` (0 without one), and the record dtype name. The
    device kind is the cache file's, not the key's."""

    kernel: str
    s: int
    n: int
    r: int = 0
    dtype: str = "int32"

    @classmethod
    def from_shape(cls, kernel: str, *, s: int, n: int, r: int = 0,
                   dtype: str = "int32") -> "TuneKey":
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
        return cls(kernel=kernel, s=_pow2_snap(max(s, 1)),
                   n=_pow2_snap(max(n, 1)),
                   r=_pow2_snap(r) if r > 0 else 0, dtype=str(dtype))

    def encode(self) -> str:
        return f"{self.kernel}/s{self.s}/n{self.n}/r{self.r}/{self.dtype}"

    @classmethod
    def decode(cls, text: str) -> "TuneKey":
        kernel, s, n, r, dtype = text.split("/")
        return cls(kernel=kernel, s=int(s[1:]), n=int(n[1:]), r=int(r[1:]),
                   dtype=dtype)


def _slug(text: str) -> str:
    out = "".join(c if c.isalnum() else "-" for c in text.lower())
    while "--" in out:
        out = out.replace("--", "-")
    return out.strip("-") or "unknown"


def _resolve(device) -> torch.device:
    from repro_torch.kernels.ops import resolve_device
    return resolve_device(device)


def device_kind(device=None) -> str:
    """Cache-file identity of the device the kernels dispatch to:
    ``gpu-<slug of the card's name>`` for a CUDA device, :data:`CPU_KIND`
    for the CPU (the plain versions). ``None`` means CUDA and raises where
    there is none, as every entry point of the port does."""
    dev = _resolve(device)
    return _kind_of(dev.type, dev.index)


@functools.lru_cache(maxsize=None)
def _kind_of(dev_type: str, index: Optional[int]) -> str:
    if dev_type == "cuda":
        return _slug(f"gpu-{torch.cuda.get_device_name(index)}")
    return CPU_KIND


def _sm_count(device=None) -> int:
    """SMs of the CUDA device (the current one for ``None``), or
    :data:`DEFAULT_SMS` where no card is there."""
    if not torch.cuda.is_available():
        return DEFAULT_SMS
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return DEFAULT_SMS
    return _build.sm_count(torch.cuda.current_device() if dev.index is None
                           else dev.index)


def heuristic_config(key: TuneKey, kind: Optional[str] = None, *,
                     sms: Optional[int] = None) -> TileConfig:
    """Pure shape-keyed chooser, the ``autotune="off"`` path.

    For a ``gpu-*`` kind: the port's shipped instances (B1 2048 records a
    block, B3/B6 4096 records a tile and 512-bucket partials, B4/B7 2048,
    B5's 512 quantum, and B2's tile as its default library picks it from
    ``s x ceil(n / 16384)`` against ``sms``, the card's SMs), so that
    ``"off"`` launches exactly what the port launched before tuning. Any
    other kind gets :data:`DEFAULT_CONFIG`, as in the reference."""
    kind = device_kind() if kind is None else kind
    if not kind.startswith("gpu"):
        return DEFAULT_CONFIG
    if key.kernel == "compact":
        sms = _sm_count() if sms is None else sms
        return _SHIPPED_COMPACT[_compact.shape_tile(key.s, key.n, sms)]
    return _SHIPPED[key.kernel]


#: the port's shipped instances, the ``gpu-*`` heuristic's answers
_SHIPPED = {
    "stream_sample": TileConfig(record_tile=_sample.DEFAULT_RECORD_TILE),
    "metrics_fused": TileConfig(record_tile=_metrics.DEFAULT_RECORD_TILE,
                                bucket_block=_metrics.BUCKET_BLOCK),
    "trend_scan": TileConfig(record_tile=_trend.DEFAULT_RECORD_TILE),
    "pair_stats": TileConfig(bucket_block=_trend.PAIR_QUANTUM),
}
_SHIPPED_COMPACT = {t: TileConfig(record_tile=t)
                    for t in _compact.RECORD_TILES}


def instances(kernel: str) -> List[TileConfig]:
    """The configs a family has instances for, smallest first."""
    if kernel == "stream_sample":
        return [TileConfig(record_tile=t) for t in _sample.RECORD_TILES]
    if kernel == "compact":
        return [TileConfig(record_tile=t) for t in _compact.RECORD_TILES]
    if kernel == "metrics_fused":
        return [TileConfig(record_tile=t, bucket_block=b)
                for t in _metrics.RECORD_TILES
                for b in _metrics.BUCKET_BLOCKS]
    if kernel == "trend_scan":
        return [TileConfig(record_tile=t) for t in _trend.RECORD_TILES]
    if kernel == "pair_stats":
        return [TileConfig(bucket_block=b) for b in _trend.PAIR_QUANTA]
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def candidate_lattice(key: TuneKey,
                      kind: Optional[str] = None) -> List[TileConfig]:
    """Measured-sweep candidates for one key: the heuristic config plus
    the family's :func:`instances`, pruned as the reference prunes its
    lattice: no record tile wider than the power-of-two-padded problem
    (the smallest instance always stays) and, for B3/B6, no bucket block
    wider than the padded bucket axis."""
    cands = [heuristic_config(key, kind)]
    family = instances(key.kernel)
    rt_cap = max(_pow2_snap(key.n), min(c.record_tile for c in family))
    bb_cap = LANE * 8
    if key.kernel == "metrics_fused" and key.r > 0:
        bb_cap = max(_pow2_snap(key.r), 2 * LANE)
    for cfg in family:
        if cfg.record_tile <= rt_cap and cfg.bucket_block <= bb_cap and \
                cfg not in cands:
            cands.append(cfg)
    return cands


def instance_builds(kernel: str, configs) -> List[_build.Target]:
    """The libraries a family's configs may need, as ``(source, defines)``:
    B2's config runs in the default library where the shape picks its tile
    anyway and in a library of that one tile elsewhere, so it needs both;
    ``pair_stats`` has one library for every quantum."""
    out = []
    for cfg in configs:
        if kernel == "stream_sample":
            ts = [_build.target("stream_sample", _sample.defines(cfg))]
        elif kernel == "compact":
            ts = [_build.target("compact"), _build.target(
                "compact", (("REPRO_RECORD_TILE", cfg.record_tile),))]
        elif kernel == "metrics_fused":
            ts = [_build.target("metrics_fused", _metrics.defines(cfg))]
        elif kernel == "trend_scan":
            ts = [_build.target("trend_scan", _trend.defines(cfg))]
        else:
            ts = [_build.target("pair_stats")]
        out.extend(t for t in ts if t not in out)
    return out


def lattice_builds() -> List[_build.Target]:
    """Every library the port's instances need, default libraries
    included (what a force sweep on a card may build)."""
    out = []
    for kernel in KERNELS:
        out.extend(t for t in instance_builds(kernel, instances(kernel))
                   if t not in out)
    return out


# --------------------------------------------------------------- sweep specs
def _spec_rng(key: TuneKey) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(key.encode().encode()))


def _spec_shapes(key: TuneKey) -> Tuple[int, int, int]:
    """Problem sizes the sweep measures: the key's shape capped (s <= 16,
    n <= 2^17, r <= 2^15) so a sweep of an enormous key stays bounded."""
    return (min(key.s, 16), min(key.n, 1 << 17),
            min(key.r, 1 << 15) if key.r > 0 else 0)


def _pad_cols(x: np.ndarray, mult: int, value) -> np.ndarray:
    pad = (-x.shape[1]) % mult
    if pad:
        fill = np.full((x.shape[0], pad), value, x.dtype)
        x = np.concatenate([x, fill], axis=1)
    return x


def _spec_stream_sample(key: TuneKey, cfg: TileConfig, dev):
    from repro_torch.kernels import ops

    s, n, r = _spec_shapes(key)
    r = max(r, 2)
    rng = _spec_rng(key)
    rows = [np.sort(rng.uniform(0.0, 3600.0, n)) for _ in range(s)]
    args = ops.stream_sample_args(ops.stream_sample_inputs(rows, r, 3.0),
                                  dev)

    def run():
        return _sample.stream_sample(*args, config=cfg)

    def reference():
        return _sample.stream_sample_plain(*args)

    return run, reference, (True, True)


def _spec_metrics(key: TuneKey, cfg: TileConfig, dev):
    s, n, r = _spec_shapes(key)
    r = max(r, 2)
    rng = _spec_rng(key)
    ss = np.sort(rng.integers(0, r, (s, n)), axis=1).astype(np.int32)
    buckets = int(-(-r // cfg.bucket_block) * cfg.bucket_block)
    ssb = torch.from_numpy(_pad_cols(ss, DEFAULT_RECORD_TILE,
                                     buckets)).to(dev)
    lengths = torch.full((s,), n, dtype=torch.int32, device=dev)

    def run():
        hist, mom = _metrics.stream_metrics(ssb, lengths, buckets,
                                            config=cfg)
        return hist[:, :r], mom

    def reference():
        hist, mom = _metrics.stream_metrics_plain(
            ssb, lengths, buckets, bucket_block=cfg.bucket_block)
        return hist[:, :r], mom

    return run, reference, (True, False)


def _spec_trend_scan(key: TuneKey, cfg: TileConfig, dev):
    s, n, _ = _spec_shapes(key)
    rng = _spec_rng(key)
    q = rng.integers(0, 7, (s, n)).astype(np.int32)
    qp = torch.from_numpy(_pad_cols(q, DEFAULT_RECORD_TILE, 0)).to(dev)

    def run():
        return (_trend.trend_scan(qp, config=cfg)[:, :n],)

    def reference():
        return (_trend.trend_scan_plain(qp)[:, :n],)

    return run, reference, (True,)


def _spec_pair_stats(key: TuneKey, cfg: TileConfig, dev):
    s, n, _ = _spec_shapes(key)
    rng = _spec_rng(key)
    x = rng.standard_normal((s, n)).astype(np.float32)
    xp = torch.from_numpy(_pad_cols(x, cfg.bucket_block, 0.0)).to(dev)

    def run():
        return _trend.pair_stats(xp, config=cfg)

    def reference():
        return _trend.pair_stats_plain(xp)

    return run, reference, (False, False)


def _spec_compact(key: TuneKey, cfg: TileConfig, dev):
    s, n, _ = _spec_shapes(key)
    rng = _spec_rng(key)
    mask = rng.random((s, n)) < 0.3
    mp = torch.from_numpy(_pad_cols(mask, DEFAULT_RECORD_TILE,
                                    False)).to(dev)

    def run():
        return _compact.compact(mp, config=cfg)

    def reference():
        return _compact.compact_plain(mp)

    return run, reference, (True, True)


#: kernel name -> spec builder returning (run(), reference(), per-output
#: exactness flags). run() launches the kernel wrapper with an explicit
#: config (never the ambient tuner, so no recursion); reference() runs its
#: plain version on the same device.
_SPECS = {
    "stream_sample": _spec_stream_sample,
    "metrics_fused": _spec_metrics,
    "trend_scan": _spec_trend_scan,
    "pair_stats": _spec_pair_stats,
    "compact": _spec_compact,
}


def _outputs_match(got, want, exact_flags) -> bool:
    for g, w, exact in zip(got, want, exact_flags):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            return False
        if exact:
            if not torch.equal(g, w):
                return False
        elif not torch.allclose(g.double(), w.double(), rtol=1e-3,
                                atol=1e-3):
            return False
    return True


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------- tuner
_PERSIST_LOCK = threading.Lock()


class KernelTuner:
    """Chooses a :class:`TileConfig` per dispatch shape.

    mode   : ``"off"`` -- heuristic only (no I/O, the default);
             ``"cached"`` -- in-memory, then the persisted cache, then a
             measured sweep; ``"force"`` -- a measured sweep, overwriting
             any persisted winner (once per key and process).
    store  : optional :class:`repro_torch.streamsim.store.StreamStore` the
             JSON cache persists under (``None``: in memory only).
    kind   : device-kind override (tests tune for a fake device); by
             default :func:`device_kind` of the device.
    reps   : timed repetitions a candidate; the score is the min.
    device : where sweeps run; ``None`` takes each dispatch's device (and
             CUDA for a call that names none).

    ``records`` holds, per device kind and key swept, every candidate's
    time in ms or the reason it was dropped, and the winner.
    """

    def __init__(self, mode: str = "off", store=None, *,
                 kind: Optional[str] = None, reps: int = 3, device=None):
        if mode not in AUTOTUNE_MODES:
            raise ValueError(
                f"autotune mode {mode!r}; one of {AUTOTUNE_MODES}")
        self.mode = mode
        self.store = store
        self._kind = kind
        self.device = device
        self.reps = max(int(reps), 1)
        self._timer = time.perf_counter
        self._mem: Dict[Tuple[str, TuneKey], TileConfig] = {}
        self.records: Dict[Tuple[str, TuneKey], Dict] = {}
        self._lock = threading.Lock()

    @property
    def kind(self) -> str:
        """The device kind of this tuner's cache file."""
        return self._kind_for(None)

    def _device_for(self, device) -> torch.device:
        return _resolve(device if device is not None else self.device)

    def _kind_for(self, device) -> str:
        if self._kind is not None:
            return self._kind
        return device_kind(self._device_for(device))

    # -- public -----------------------------------------------------------
    def config_for(self, kernel: str, *, s: int, n: int, r: int = 0,
                   dtype: str = "int32", device=None) -> TileConfig:
        """The config a dispatch of this shape on ``device`` should use
        (may sweep)."""
        if self.mode == "off":
            if kernel not in KERNELS:
                raise ValueError(f"unknown kernel {kernel!r}; one of "
                                 f"{KERNELS}")
            # the unsnapped shape: B2's default tile depends on it
            kind = self._kind_for(device)
            sms = None
            if kernel == "compact" and kind.startswith("gpu"):
                sms = _sm_count(device if device is not None
                                else self.device)
            return heuristic_config(
                TuneKey(kernel, max(int(s), 1), max(int(n), 1), int(r),
                        str(dtype)), kind, sms=sms)
        key = TuneKey.from_shape(kernel, s=s, n=n, r=r, dtype=dtype)
        kind = self._kind_for(device)
        with self._lock:
            hit = self._mem.get((kind, key))
        if hit is not None:
            return hit
        if self.mode == "cached":
            disk = self._load_cache(kind).get(key)
            if disk is not None:
                with self._lock:
                    self._mem[(kind, key)] = disk
                return disk
        cfg = self._sweep(key, kind, device)
        with self._lock:
            self._mem[(kind, key)] = cfg
        self._persist(key, cfg, kind)
        return cfg

    def dropped(self) -> List[Tuple[str, Dict]]:
        """``(key, candidate record)`` of every candidate a sweep dropped."""
        return [(k.encode(), c) for (_, k), rec in self.records.items()
                for c in rec["candidates"] if "dropped" in c]

    # -- measured sweep ---------------------------------------------------
    def _time_once(self, fn, device) -> float:
        t0 = self._timer()
        fn()
        _sync(device)
        return self._timer() - t0

    def _sweep(self, key: TuneKey, kind: Optional[str] = None,
               device=None) -> TileConfig:
        """Build the candidates, hold each to the plain version on the same
        device, time those that match and return the fastest; a candidate
        that fails to build, to launch or to match is dropped and recorded.
        With no candidate left, or a failure outside them, the heuristic
        config."""
        kind = self._kind_for(device) if kind is None else kind
        fallback = heuristic_config(key, kind)
        spec = _SPECS.get(key.kernel)
        record = {"candidates": [], "winner": None}
        self.records[(kind, key)] = record
        if spec is None:
            return fallback
        best_cfg, best_t = None, float("inf")
        try:
            dev = self._device_for(device)
            cands = candidate_lattice(key, kind)
            failed = {}
            if dev.type == "cuda":
                failed = _build.build_many(
                    instance_builds(key.kernel, cands))
            want = None
            for cfg in cands:
                entry = {"config": cfg.as_dict()}
                record["candidates"].append(entry)
                bad = [e for t, e in failed.items()
                       if t in instance_builds(key.kernel, [cfg])]
                if bad:
                    entry["dropped"] = f"build: {bad[0]}"
                    continue
                run, reference, exact_flags = spec(key, cfg, dev)
                try:
                    out = run()
                    _sync(dev)
                except Exception as e:        # a launch the card refused
                    entry["dropped"] = f"launch: {e}"
                    continue
                if want is None:
                    want = reference()
                if not _outputs_match(out, want, exact_flags):
                    entry["dropped"] = "mismatch"
                    continue
                try:
                    t = min(self._time_once(run, dev)
                            for _ in range(self.reps))
                except Exception as e:
                    entry["dropped"] = f"timing: {e}"
                    continue
                entry["ms"] = t * 1e3
                if t < best_t:
                    best_cfg, best_t = cfg, t
        except Exception as e:
            record["error"] = str(e)
            best_cfg = None
        winner = best_cfg if best_cfg is not None else fallback
        record["winner"] = winner.as_dict()
        return winner

    # -- persistence ------------------------------------------------------
    def _load_cache(self, kind: Optional[str] = None
                    ) -> Dict[TuneKey, TileConfig]:
        """Winners persisted for the device kind; ``{}`` on any problem (a
        missing, corrupt or partly written file falls back to the
        heuristic, never raises into a dispatch). On a ``gpu-*`` kind an
        entry naming a tile the port has no instance for (written by the
        reference's tuner for the same card) is skipped."""
        kind = self.kind if kind is None else kind
        if self.store is None:
            return {}
        try:
            payload = self.store.get_marker(TUNE_NAMESPACE, kind)
        except Exception:
            return {}
        out: Dict[TuneKey, TileConfig] = {}
        if not isinstance(payload, dict):
            return out
        entries = payload.get("entries", {})
        if not isinstance(entries, dict):
            return out
        for text, entry in entries.items():
            try:
                key = TuneKey.decode(text)
                cfg = TileConfig.from_dict(entry)
                if kind.startswith("gpu") and not _has_instance(key, cfg):
                    continue
                out[key] = cfg
            except Exception:
                continue
        return out

    def _persist(self, key: TuneKey, cfg: TileConfig,
                 kind: Optional[str] = None) -> None:
        if self.store is None:
            return
        kind = self.kind if kind is None else kind
        with _PERSIST_LOCK:
            entries = {k.encode(): c.as_dict()
                       for k, c in self._load_cache(kind).items()}
            entries[key.encode()] = cfg.as_dict()
            self.store.put_marker(TUNE_NAMESPACE, kind, {
                "version": 1,
                "device_kind": kind,
                "entries": entries,
            })


def _has_instance(key: TuneKey, cfg: TileConfig) -> bool:
    """Whether ``cfg`` names one of the family's instances on a card (the
    fields the family does not read are free)."""
    if key.kernel not in KERNELS:
        return False
    if key.kernel == "pair_stats":
        return cfg.bucket_block in _trend.PAIR_QUANTA
    tiles = {c.record_tile for c in instances(key.kernel)}
    if key.kernel == "metrics_fused":
        return cfg.record_tile in tiles and \
            cfg.bucket_block in _metrics.BUCKET_BLOCKS
    return cfg.record_tile in tiles


# ------------------------------------------------------- ambient tuner knob
_DEFAULT_TUNER = KernelTuner("off")
_TLS = threading.local()


def current() -> KernelTuner:
    """The tuner the ops dispatches consult (the innermost :func:`use`)."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else _DEFAULT_TUNER


@contextlib.contextmanager
def use(tuner: Optional[KernelTuner]):
    """Install ``tuner`` as the ambient tuner of the calling thread
    (``None`` is a no-op, so callers pass their knob through as it is)."""
    if tuner is None:
        yield
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(tuner)
    try:
        yield
    finally:
        stack.pop()


def config_for(kernel: str, *, s: int, n: int, r: int = 0,
               dtype: str = "int32", device=None) -> TileConfig:
    """The ambient tuner's config for a dispatch on ``device``, the call
    the ops wrappers make."""
    return current().config_for(kernel, s=s, n=n, r=r, dtype=dtype,
                                device=device)


_SHARED: Dict[Tuple, KernelTuner] = {}
_SHARED_LOCK = threading.Lock()


def shared_tuner(mode: str, store=None, kind: Optional[str] = None,
                 device=None) -> Optional[KernelTuner]:
    """Process-wide registry: one tuner per (mode, store root, device
    kind, device), so repeated sweeps and runs share the in-memory winners.
    ``None`` and ``"off"`` map to ``None`` (nothing to install); an unknown
    mode raises ``ValueError``. Nothing here asks for a device: the tuner
    resolves its kind at its first dispatch."""
    if mode is None or mode == "off":
        return None
    if mode not in AUTOTUNE_MODES:
        raise ValueError(f"autotune mode {mode!r}; one of {AUTOTUNE_MODES}")
    root = str(getattr(store, "root", ""))
    reg_key = (mode, root, kind,
               None if device is None else str(torch.device(device)))
    with _SHARED_LOCK:
        tuner = _SHARED.get(reg_key)
        if tuner is None:
            tuner = KernelTuner(mode, store=store, kind=kind, device=device)
            _SHARED[reg_key] = tuner
        return tuner


def tuner_context(autotune: Optional[str], store=None,
                  kind: Optional[str] = None, device=None):
    """``with tuning.tuner_context(autotune, store, device=...): ...``, what
    the layers wrap their device legs in. ``None`` and ``"off"`` install
    nothing; an unknown mode raises ``ValueError`` here, at the knob."""
    return use(shared_tuner(autotune, store=store, kind=kind, device=device))


__all__ = [
    "AUTOTUNE_MODES", "DEFAULT_BUCKET_BLOCK", "DEFAULT_CONFIG",
    "DEFAULT_RECORD_TILE", "KERNELS", "KernelTuner", "LANE",
    "MIN_RECORD_TILE", "TUNE_NAMESPACE", "TileConfig", "TuneKey",
    "VMEM_BUDGET_BYTES", "candidate_lattice", "config_for", "current",
    "device_kind", "heuristic_config", "shared_tuner", "tuner_context",
    "use", "CPU_KIND", "instances", "lattice_builds",
]
