"""``StreamStore.get`` of a ``columns.npz``: the time columns read whole in
one pass, the payload columns mapped in place, and ``np.load`` where a file
cannot be read so.

Every read is held to ``np.load`` of the same file (dtype, shape, bytes),
and the span ``store.read`` says how many bytes were mapped.
"""

import hashlib
import zipfile

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.streamsim as J
import repro_torch.streamsim as T
from repro_torch import tracing

SMALL = [("sogouq", 0.002, 3), ("traffic", 0.004, 5),
         ("userbehavior", 0.002, 7)]


@pytest.fixture(autouse=True)
def _clean_tracer():
    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()


@pytest.fixture(scope="module")
def originals():
    return {name: T.preprocess(T.make_stream(name, scale=sc, seed=seed))
            for name, sc, seed in SMALL}


def _get(store, key):
    """``store.get(key)`` and its ``store.read`` span's counts."""
    tracing.enable()
    stream = store.get(key)
    tracing.enable(False)
    (r,) = [r for r in tracing.drain() if r.name == "store.read"]
    return stream, r.counts


def _columns(stream):
    out = {"__t__": stream.t}
    if stream.scale_stamp is not None:
        out["__scale_stamp__"] = stream.scale_stamp
    out.update({f"c:{k}": v for k, v in stream.payload.items()})
    return out


def _same_as_np_load(stream, path):
    got = _columns(stream)
    with np.load(path, allow_pickle=False) as z:
        assert list(got) == z.files
        for k in z.files:
            want = z[k]
            assert got[k].dtype == want.dtype, k
            assert got[k].shape == want.shape, k
            assert got[k].tobytes() == want.tobytes(), k
            assert type(got[k]) is np.ndarray and got[k].flags.writeable


def _payload_bytes(stream):
    return sum(v.nbytes for v in stream.payload.values())


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("name", [n for n, _, _ in SMALL])
def test_original_reads_as_np_load_with_the_payload_mapped(
        tmp_path, originals, name):
    store = T.StreamStore(tmp_path)
    store.put(f"{name}__orig", originals[name])
    got, counts = _get(store, f"{name}__orig")
    path = tmp_path / f"{name}__orig" / "columns.npz"
    _same_as_np_load(got, path)
    assert counts["bytes"] == path.stat().st_size
    assert counts["mapped"] == _payload_bytes(got) > 0
    # the time column is an array of its own, aligned; the payload is not
    assert got.t.flags.owndata and got.t.flags.aligned
    assert all(not v.flags.owndata for v in got.payload.values())


@pytest.mark.parametrize("max_range", [60, 3600])
def test_stored_sim_reads_its_scale_stamp_whole(tmp_path, originals,
                                                max_range):
    sim = T.nsa(originals["userbehavior"], max_range, backend="numpy")
    assert sim.scale_stamp is not None
    store = T.StreamStore(tmp_path)
    store.put("userbehavior__sim", sim, {"max_range": max_range})
    got, counts = _get(store, "userbehavior__sim")
    _same_as_np_load(got, tmp_path / "userbehavior__sim" / "columns.npz")
    assert got.scale_stamp.flags.owndata
    assert counts["mapped"] == _payload_bytes(got) > 0


def test_compressed_file_falls_back_to_np_load(tmp_path, originals):
    store = T.StreamStore(tmp_path)
    store.put("k", originals["traffic"])
    path = tmp_path / "k" / "columns.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    np.savez_compressed(path, **arrays)
    got, counts = _get(store, "k")
    _same_as_np_load(got, path)
    assert counts["mapped"] == 0


@pytest.mark.parametrize("column", [
    np.zeros(7, dtype=[("a", "<i8"), ("b", "<f4")]),
    np.asfortranarray(np.arange(14, dtype=np.int64).reshape(7, 2)),
], ids=["structured", "fortran-2d"])
def test_column_that_cannot_be_mapped_falls_back(tmp_path, column):
    store = T.StreamStore(tmp_path)
    stream = T.Stream("x", np.arange(7.0), {"a": np.arange(7),
                                            "odd": column})
    store.put("k", stream)
    got, counts = _get(store, "k")
    _same_as_np_load(got, tmp_path / "k" / "columns.npz")
    assert counts["mapped"] == 0


def _np_load_all(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("cut", ["empty", "head", "half", "last-byte"])
def test_truncated_file_raises_as_np_load_does(tmp_path, originals, cut):
    store = T.StreamStore(tmp_path)
    store.put("k", originals["userbehavior"])
    path = tmp_path / "k" / "columns.npz"
    data = path.read_bytes()
    keep = {"empty": 0, "head": 100, "half": len(data) // 2,
            "last-byte": len(data) - 1}[cut]
    path.write_bytes(data[:keep])
    with pytest.raises(Exception) as today:
        _np_load_all(path)
    with pytest.raises(today.type):
        store.get("k")


def _break_signature(path, stream):
    """A payload member's local header without its signature."""
    with zipfile.ZipFile(path) as z:
        at = z.getinfo("c:" + next(iter(stream.payload)) + ".npy")
    data = bytearray(path.read_bytes())
    data[at.header_offset:at.header_offset + 4] = b"XX\x03\x04"
    path.write_bytes(bytes(data))


def _break_extent(path, stream):
    """The time column's npy header claims more rows than its member holds
    (the same number of digits, so the header keeps its length)."""
    n = str(len(stream))
    assert n != "9" * len(n)
    data = path.read_bytes()
    old, new = f"({n},)".encode(), f"({'9' * len(n)},)".encode()
    assert old in data
    path.write_bytes(data.replace(old, new, 1))


@pytest.mark.parametrize("brk", [_break_signature, _break_extent],
                         ids=["signature", "extent"])
def test_broken_member_raises_as_np_load_does(tmp_path, originals, brk):
    store = T.StreamStore(tmp_path)
    store.put("k", originals["traffic"])
    path = tmp_path / "k" / "columns.npz"
    brk(path, originals["traffic"])
    with pytest.raises(Exception) as today:
        _np_load_all(path)
    with pytest.raises(today.type):
        store.get("k")


def test_a_write_to_a_payload_column_stays_in_memory(tmp_path, originals):
    store = T.StreamStore(tmp_path)
    store.put("k", originals["userbehavior"])
    path = tmp_path / "k" / "columns.npz"
    before = _digest(path)
    got = store.get("k")
    for v in got.payload.values():
        v[:] = v[::-1]
    assert _digest(path) == before
    again = store.get("k")
    for k, v in originals["userbehavior"].payload.items():
        assert again.payload[k].tobytes() == v.tobytes()
        assert got.payload[k].tobytes() == v[::-1].tobytes()


def test_delete_while_the_arrays_live(tmp_path, originals):
    store = T.StreamStore(tmp_path)
    want = originals["sogouq"]
    store.put("k", want)
    got = store.get("k")
    store.delete("k")
    assert not store.exists("k") and not (tmp_path / "k").exists()
    assert got.t.tobytes() == want.t.tobytes()
    for k, v in want.payload.items():
        assert got.payload[k].tobytes() == v.tobytes()
        assert got.payload[k][[0, -1]].tolist() == v[[0, -1]].tolist()


@pytest.mark.parametrize("name", [n for n, _, _ in SMALL])
def test_store_written_by_the_jax_package_is_mapped(tmp_path, name):
    _, scale, seed = next(s for s in SMALL if s[0] == name)
    orig = J.preprocess(J.make_stream(name, scale=scale, seed=seed))
    sim = J.nsa(orig, 60)
    J.StreamStore(tmp_path).put("orig", orig)
    J.StreamStore(tmp_path).put("sim", sim, {"max_range": 60})
    store = T.StreamStore(tmp_path)
    for key in ("orig", "sim"):
        got, counts = _get(store, key)
        _same_as_np_load(got, tmp_path / key / "columns.npz")
        assert counts["mapped"] == _payload_bytes(got) > 0


def test_chunked_stream_counts_nothing_mapped(tmp_path, originals):
    store = T.StreamStore(tmp_path)
    sim = T.nsa(originals["traffic"], 60, backend="numpy")
    half = len(sim) // 2
    for i, sl in enumerate((slice(0, half), slice(half, None))):
        store.append_chunk("k", i, T.Stream(
            sim.name, sim.t[sl], {k: v[sl] for k, v in sim.payload.items()},
            sim.scale_stamp[sl]))
    store.finalize_chunks("k", name=sim.name, n_chunks=2)
    got, counts = _get(store, "k")
    assert counts["mapped"] == 0
    assert got.t.tobytes() == sim.t.tobytes()
    assert got.scale_stamp.tobytes() == sim.scale_stamp.tobytes()
    for k, v in sim.payload.items():
        assert got.payload[k].tobytes() == v.tobytes()
