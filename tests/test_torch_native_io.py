# SPDX-License-Identifier: CECILL-2.1
"""The port's bindings of the native C++ codec (``native/dipio.cpp``), run
as ``tests/test_native_io.py`` runs the JAX package's: against the Python
parser, on handcrafted TIFF layouts, through ``AsyncStackLoader`` (order and
values, a corrupt file mid-sequence, the closed-loader error), and against
the JAX package's bindings of the same source (equal arrays, dtype and byte
order). The library is built with g++ under a temporary directory, never
into the checkout nor the JAX package's cache; without g++ these tests skip.
"""
import shutil

import numpy as np
import pytest
import torch

import barc4dip_tpu.io.native as jnative
import barc4dip_tpu_torch.io as tio
import barc4dip_tpu_torch.io.native as tnative
from barc4dip_tpu_torch.config import upload
from tests.test_io import _make_edf_bytes
from tests.test_native_io import _make_tiff_bytes


@pytest.fixture(scope="module", autouse=True)
def built(tmp_path_factory):
    """The port's library, built afresh under a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native codec cannot be built")
    saved = (tnative.BUILD_DIR, tnative._lib, tnative._load_error)
    tnative.BUILD_DIR = tmp_path_factory.mktemp("native_build")
    tnative._lib = tnative._load_error = None
    try:
        assert tnative.native_available(), tnative.load_error()
        yield tnative.BUILD_DIR
    finally:
        tnative.BUILD_DIR, tnative._lib, tnative._load_error = saved


def test_library_is_built_once_under_the_build_dir(built):
    libs = list(built.iterdir())
    assert [p.suffix for p in libs] == [".so"] and libs[0].name.startswith("libdipio-")
    assert tnative.load_error() is None
    assert sorted(n for n in tnative.__all__ if n not in ("native_io_requested", "load_error")) \
        == sorted(jnative.__all__)


def test_failed_build_reports_the_compiler(tmp_path, monkeypatch):
    bad = tmp_path / "dipio.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_error", None)
    assert not tnative.native_available()
    assert "native build failed" in tnative.load_error() and "error" in tnative.load_error()
    assert not list((tmp_path / "out").glob("*"))  # no half-written library left
    with pytest.raises(RuntimeError, match="native I/O unavailable"):
        tnative.NativeEdfFile(tmp_path / "x.edf")
    monkeypatch.setenv("BARC4DIP_TORCH_NATIVE_IO", "1")
    assert not tnative.native_io_requested()
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(tnative, "_load_error", None)
    assert "native source not found" in tnative.load_error()


def test_native_matches_python_parser_and_jax(tmp_path):
    arrs = [(np.arange(30, dtype=np.uint16) * 3).reshape(5, 6),
            np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)]
    path = tmp_path / "multi.edf"
    path.write_bytes(_make_edf_bytes(arrs))
    nat, py, jnat = tnative.NativeEdfFile(path), tio.EdfFile(path), jnative.NativeEdfFile(path)
    assert nat.NumImages == nat.GetNumImages() == py.NumImages == jnat.NumImages == 2
    for i in range(2):
        got = nat.GetData(i)
        assert got.dtype == py.GetData(i).dtype == jnat.GetData(i).dtype
        np.testing.assert_array_equal(got, py.GetData(i))
        np.testing.assert_array_equal(got, jnat.GetData(i))
    nat.close()
    jnat.close()
    with pytest.raises(RuntimeError, match="closed"):
        nat.GetData(0)


def test_native_read_edf_and_512_header(tmp_path):
    arr = (np.arange(20, dtype=np.uint16) * 9).reshape(4, 5)
    path = tmp_path / "pad512.edf"
    path.write_bytes(_make_edf_bytes([arr, arr + 2], block=512))
    out = tnative.read_edf_native(path, index=1)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, arr + 2)
    np.testing.assert_array_equal(out, jnative.read_edf_native(path, index=1))
    assert tnative.read_edf_native(path, dtype=np.uint16).dtype == np.uint16


def test_native_errors_equal_jax(tmp_path):
    (tmp_path / "bad.edf").write_bytes(b"this is not an EDF file")
    good = _make_edf_bytes([np.zeros((2, 4), np.uint16)])
    (tmp_path / "neg.edf").write_bytes(good.replace(b"Dim_1 = 4 ;", b"Dim_1 = -8 ;"))
    (tmp_path / "trunc.edf").write_bytes(_make_edf_bytes([np.zeros((64, 64), np.uint16)])[:-100])
    for name in ("bad.edf", "missing.edf", "neg.edf", "trunc.edf"):
        with pytest.raises(OSError) as want:
            jnative.NativeEdfFile(tmp_path / name)
        with pytest.raises(OSError) as got:
            tnative.NativeEdfFile(tmp_path / name)
        assert str(got.value) == str(want.value)
    (tmp_path / "ok.edf").write_bytes(good)
    f = tnative.NativeEdfFile(tmp_path / "ok.edf")
    with pytest.raises(IndexError):
        f.GetData(5)
    f.close()


def _edf_series(tmp_path, n, shape=(16, 20), seed=1):
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(0, 60000, size=shape).astype(np.uint16) for _ in range(n)]
    paths = []
    for i, a in enumerate(arrs):
        p = tmp_path / f"f{i:03d}.edf"
        p.write_bytes(_make_edf_bytes([a]))
        paths.append(str(p))
    return arrs, paths


def test_async_stack_loader_order_and_values(tmp_path):
    arrs, paths = _edf_series(tmp_path, 12)
    loader = tnative.AsyncStackLoader(paths, n_threads=3, window=4)
    assert len(loader) == 12
    frames = list(loader)
    assert len(frames) == 12
    for got, want, ref in zip(frames, arrs, jnative.AsyncStackLoader(paths, n_threads=3, window=4)):
        assert got.dtype == ref.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)


def test_async_loader_frames_go_to_pinned_style_tensors(tmp_path):
    """Big-endian files come out of the prefetcher in native byte order, so
    ``torch.from_numpy`` takes every frame as it is."""
    arr = (np.arange(24, dtype=np.uint16) * 513 + 7).reshape(4, 6)
    (tmp_path / "be.edf").write_bytes(_make_edf_bytes([arr], big_endian=True))
    (tmp_path / "le.edf").write_bytes(_make_edf_bytes([arr]))
    frames = list(tnative.AsyncStackLoader([str(tmp_path / "be.edf"), str(tmp_path / "le.edf")],
                                           n_threads=1, window=2))
    for frame in frames:
        assert frame.dtype.isnative
        np.testing.assert_array_equal(frame, arr)
        assert torch.from_numpy(frame).to(torch.int32).sum() == int(arr.sum())


def test_big_endian_arrays_upload(tmp_path):
    """``GetData`` hands a big-endian EDF's pixels back in the file's byte
    order, as the JAX package does (``read_edf`` and the TIFF codec give
    native order); ``config.upload`` swaps such an array before torch sees
    it."""
    arr = np.random.default_rng(2).integers(0, 60000, size=(19, 11)).astype(np.uint16)
    (tmp_path / "be.edf").write_bytes(_make_edf_bytes([arr], big_endian=True))
    (tmp_path / "be.tif").write_bytes(_make_tiff_bytes(arr, big_endian=True))
    f = tnative.NativeEdfFile(tmp_path / "be.edf")
    raw = f.GetData(0)
    f.close()
    assert raw.dtype == np.dtype(">u2") == tio.EdfFile(tmp_path / "be.edf").GetData(0).dtype
    tif = tnative.read_tiff_native(tmp_path / "be.tif")
    assert tif.dtype.isnative and jnative.read_tiff_native(tmp_path / "be.tif").dtype.isnative
    with pytest.raises((TypeError, ValueError)):
        torch.from_numpy(raw)
    for x in (raw, raw[::2], tif):
        t = upload(x, torch.device("cpu"))
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(x, np.float32))
    assert tnative.read_edf_native(tmp_path / "be.edf").dtype.isnative


def test_async_loader_large_frames_grow_and_closed_loader(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=(600, 600)).astype(np.float64) for _ in range(2)]  # 2.88 MB > 1 MiB
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"big{i}.edf"))
        tio.save_edf(f, paths[-1])
    loader = tnative.AsyncStackLoader(paths)
    got = [next(loader) for _ in range(2)]
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    got[0][0, 0] = 1.0  # returned frames are writable
    with pytest.raises(StopIteration):
        next(loader)
    fresh = tnative.AsyncStackLoader(paths)
    fresh.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(fresh)


def test_async_loader_corrupt_file_mid_sequence(tmp_path):
    arrs, paths = _edf_series(tmp_path, 4, shape=(8, 10), seed=7)
    (tmp_path / "f002.edf").write_bytes(b"garbage, not a frame container")
    got = []
    with pytest.raises(OSError):
        for frame in tnative.AsyncStackLoader(paths, n_threads=2, window=2):
            got.append(frame)
    assert len(got) == 2
    for g, want in zip(got, arrs[:2]):
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("big_endian", [False, True], ids=["le", "be"])
@pytest.mark.parametrize("n_strips", [1, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.uint32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_handcrafted_tiff_layouts(tmp_path, big_endian, n_strips, dtype):
    rng = np.random.default_rng(4)
    if np.issubdtype(dtype, np.floating):
        arr = rng.normal(size=(19, 11)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, info.max, size=(19, 11)).astype(dtype)
    p = tmp_path / "hand.tif"
    p.write_bytes(_make_tiff_bytes(arr, big_endian=big_endian, n_strips=n_strips))
    got, ref = tnative.read_tiff_native(p), jnative.read_tiff_native(p)
    assert got.dtype == ref.dtype and got.dtype.byteorder == ref.dtype.byteorder
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)
    assert tnative.read_tiff_native(p, dtype=np.float64).dtype == np.float64


def test_native_tiff_against_pillow_and_compressed(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(3).integers(0, 60000, size=(37, 23)).astype(np.uint16)
    Image.fromarray(arr).save(tmp_path / "pil.tif")
    f = tnative.NativeTiffFile(tmp_path / "pil.tif")
    assert f.NumImages == 1
    np.testing.assert_array_equal(f.GetData(0), arr)
    f.close()
    (tmp_path / "lzw.tif").write_bytes(_make_tiff_bytes(np.zeros((4, 4), np.uint16), compression=5))
    with pytest.raises(OSError, match="compression"):
        tnative.NativeTiffFile(tmp_path / "lzw.tif")


def test_env_gate_routes_readers(tmp_path, monkeypatch):
    """BARC4DIP_TORCH_NATIVE_IO switches the codec on for ``read_tiff`` and
    ``read_edf``; the JAX package's variable does not; a compressed TIFF and
    a gzipped EDF still decode (the host readers' format dispatch)."""
    from PIL import Image

    arr = np.random.default_rng(5).integers(0, 60000, size=(12, 9)).astype(np.uint16)
    Image.fromarray(arr).save(tmp_path / "route.tif")
    Image.fromarray(arr).save(tmp_path / "deflate.tif", compression="tiff_adobe_deflate")
    (tmp_path / "route.edf").write_bytes(_make_edf_bytes([arr, arr + 1]))
    import gzip

    (tmp_path / "z.edf.gz").write_bytes(gzip.compress(_make_edf_bytes([arr])))

    calls = {"tiff": 0, "edf": 0}
    real_tiff, real_edf = tnative.read_tiff_native, tnative.read_edf_native
    monkeypatch.setattr(tnative, "read_tiff_native",
                        lambda *a, **k: (calls.__setitem__("tiff", calls["tiff"] + 1), real_tiff(*a, **k))[1])
    monkeypatch.setattr(tnative, "read_edf_native",
                        lambda *a, **k: (calls.__setitem__("edf", calls["edf"] + 1), real_edf(*a, **k))[1])

    monkeypatch.delenv("BARC4DIP_TORCH_NATIVE_IO", raising=False)
    monkeypatch.setenv("BARC4DIP_TPU_NATIVE_IO", "1")
    assert not tnative.native_io_requested()
    np.testing.assert_array_equal(tio.read_tiff(str(tmp_path / "route.tif")), arr)
    np.testing.assert_array_equal(tio.read_edf(str(tmp_path / "route.edf")), arr)
    assert calls == {"tiff": 0, "edf": 0}

    for value in ("1", "true", "YES", " on "):
        monkeypatch.setenv("BARC4DIP_TORCH_NATIVE_IO", value)
        assert tnative.native_io_requested()
    for value in ("0", "", "off"):
        monkeypatch.setenv("BARC4DIP_TORCH_NATIVE_IO", value)
        assert not tnative.native_io_requested()
    monkeypatch.setenv("BARC4DIP_TORCH_NATIVE_IO", "1")
    np.testing.assert_array_equal(tio.read_tiff(str(tmp_path / "route.tif")), arr)
    np.testing.assert_array_equal(tio.read_edf(str(tmp_path / "route.edf"), index=1), arr + 1)
    assert calls == {"tiff": 1, "edf": 1}
    np.testing.assert_array_equal(tio.read_tiff(str(tmp_path / "deflate.tif")), arr)
    np.testing.assert_array_equal(tio.read_edf(str(tmp_path / "z.edf.gz")), arr)
    assert calls == {"tiff": 2, "edf": 1}  # asked, refused, decoded by Pillow
    np.testing.assert_array_equal(
        tio.read_image([str(tmp_path / "route.tif"), str(tmp_path / "deflate.tif")]), [arr, arr])


def test_fixtures_through_the_native_reader(monkeypatch):
    from pathlib import Path

    data = Path(__file__).parent / "data"
    monkeypatch.setenv("BARC4DIP_TORCH_NATIVE_IO", "1")
    expected = np.load(data / "fixture_u16_expected.npy")
    for i in range(2):
        got = tio.read_edf(str(data / "fixture_u16.edf"), index=i)
        np.testing.assert_array_equal(got, expected[i].astype(got.dtype))
    np.testing.assert_array_equal(tnative.read_edf_native(data / "fixture_f32.edf"),
                                  np.load(data / "fixture_f32_expected.npy"))


def test_async_loader_mixed_formats(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    arrs = [rng.integers(0, 60000, size=(16, 20)).astype(np.uint16) for _ in range(6)]
    paths = []
    for i, a in enumerate(arrs):
        if i % 2 == 0:
            p = tmp_path / f"f{i:02d}.edf"
            p.write_bytes(_make_edf_bytes([a]))
        else:
            p = tmp_path / f"f{i:02d}.tif"
            Image.fromarray(a).save(p)
        paths.append(str(p))
    frames = list(tnative.AsyncStackLoader(paths, n_threads=3, window=3))
    assert len(frames) == 6
    for got, want in zip(frames, arrs):
        np.testing.assert_array_equal(got, want)
