# SPDX-License-Identifier: CECILL-2.1
"""The port's ``io`` package against the JAX package's, on the same files.

Readers: every case of ``tests/test_io.py`` and every committed fixture
under ``tests/data`` goes through both packages; arrays are exactly equal,
with equal dtype and byte order, and an error has the same type and the
same message. Writers: a file written by either package is read by the
other, both ways; the EDF bytes of the two writers are equal. The port
imports ``h5py`` and Pillow only where a call needs them, and says which is
missing. Where the port converts to uint16 it is given ``device="cpu"``."""
import gzip
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

import barc4dip_tpu.io as jio
import barc4dip_tpu.io.edf as jedf
import barc4dip_tpu_torch.io as tio
import barc4dip_tpu_torch.io.edf as tedf
from tests.test_io import TestWrappedContainers, _make_edf_bytes

DATA = Path(__file__).parent / "data"
_WRAP = TestWrappedContainers()


def same(call):
    """``call(io_module)`` through both packages: equal results (arrays
    with equal dtype and byte order), or the same error with the same
    message. Returns the port's result."""
    try:
        want = call(jio)
    except Exception as exc:  # noqa: BLE001 - any error must be mirrored
        with pytest.raises(type(exc)) as got:
            call(tio)
        assert type(got.value) is type(exc)
        assert str(got.value) == str(exc)
        return None
    got = call(tio)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.dtype.byteorder == want.dtype.byteorder
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.flags.writeable == want.flags.writeable
    else:
        assert got == want
    return got


# -- reader cases: each builds its files and returns the calls to mirror ------

def _edf_single(d):
    arr = (np.arange(12, dtype=np.uint16) * 7).reshape(3, 4)
    p = d / "one.edf"
    p.write_bytes(_make_edf_bytes([arr]))
    return [lambda io: io.EdfFile(p).NumImages, lambda io: io.EdfFile(p).GetData(0),
            lambda io: io.read_edf(str(p)), lambda io: io.read_edf(str(p), dtype=np.float64),
            lambda io: io.read_edf(str(p), index=1), lambda io: io.read_edf(str(p), index=-1),
            lambda io: io.EdfFile(p).GetData(3), lambda io: io.uti_EdfFile.EdfFile(p).GetData(0)]


def _edf_multi_float(d):
    a = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    p = d / "two.edf"
    p.write_bytes(_make_edf_bytes([a, (a * 2).astype(np.float32)]))
    return [lambda io: io.EdfFile(p).GetNumImages(), lambda io: io.EdfFile(p).GetData(1),
            lambda io: io.EdfFile(p).GetHeader(0), lambda io: io.read_edf(str(p), index=1)]


def _edf_gzip_bz2(d):
    import bz2

    arr = np.arange(20, dtype=np.uint16).reshape(4, 5)
    pz, pb = d / "z.edf.gz", d / "b.edf.bz2"
    pz.write_bytes(gzip.compress(_make_edf_bytes([arr])))
    pb.write_bytes(bz2.compress(_make_edf_bytes([arr, arr + 1])))
    return [lambda io: io.read_edf(str(pz)), lambda io: io.read_image(str(pz)),
            lambda io: io.read_edf(str(pb), index=1), lambda io: io.read_image(str(pb)),
            lambda io: io.EdfFile(pb).GetRegion(1, (1, 1), (2, 3))]


def _edf_sequence(d):
    paths = []
    for i in range(3):
        p = d / f"f{i}.edf"
        p.write_bytes(_make_edf_bytes([np.full((3, 3), i, dtype=np.uint16)]))
        paths.append(str(p))
    odd = d / "odd.edf"
    odd.write_bytes(_make_edf_bytes([np.zeros((2, 5), np.uint16)]))
    return [lambda io: io.read_edf(paths), lambda io: io.read_image(paths),
            lambda io: io.read_edf(tuple(paths)), lambda io: io.read_edf([*paths, str(odd)]),
            lambda io: io.read_edf([]), lambda io: io.read_edf([paths[0], 3]),
            lambda io: io.read_edf(7), lambda io: io.read_edf(str(d / "missing.edf"))]


def _edf_512(d):
    arr = (np.arange(20, dtype=np.uint16) * 11).reshape(4, 5)
    p = d / "pad512.edf"
    p.write_bytes(_make_edf_bytes([arr, arr + 1], block=512))
    return [lambda io: io.EdfFile(p).NumImages, lambda io: io.EdfFile(p).GetData(0),
            lambda io: io.EdfFile(p).GetData(1)]


def _edf_big_endian(d):
    arr = (np.arange(12, dtype=np.uint16) * 257).reshape(3, 4)
    p = d / "be.edf"
    p.write_bytes(_make_edf_bytes([arr], big_endian=True))
    return [lambda io: io.EdfFile(p).GetData(0), lambda io: io.read_edf(str(p)),
            lambda io: io.read_edf(str(p), dtype=np.uint16)]


def _edf_corrupt(d):
    good = _make_edf_bytes([np.zeros((2, 4), np.uint16)])
    files = {
        "neg.edf": good.replace(b"Dim_1 = 4 ;", b"Dim_1 = -8 ;"),
        "small.edf": good.replace(b"Size = 16 ;", b"Size = 3 ;"),
        "nodim.edf": good.replace(b"Dim_1 = 4 ;", b"Dim_9 = 4 ;"),
        "dtype.edf": good.replace(b"UnsignedShort", b"ComplexValue "),
        "brace.edf": b"not an edf",
        "open.edf": b"{ Dim_1 = 4 ;",
        "trunc.edf": good[:-3],
    }
    for name, raw in files.items():
        (d / name).write_bytes(raw)
    return [lambda io, n=n: io.EdfFile(d / n).GetData(0) for n in files]


def _edf_oversized_size(d):
    a = np.arange(8, dtype=np.uint16).reshape(2, 4)
    raw = _make_edf_bytes([a]).replace(b"Size = 16 ;", b"Size = 24 ;") + b"\x00" * 8
    p = d / "padded.edf"
    p.write_bytes(raw + _make_edf_bytes([a + 100]))
    return [lambda io: io.EdfFile(p).NumImages, lambda io: io.EdfFile(p).GetData(0),
            lambda io: io.EdfFile(p).GetData(1)]


def _edf_region(d):
    arr = np.random.default_rng(5).integers(0, 60000, size=(16, 12)).astype(np.uint16)
    p = d / "reg.edf"
    p.write_bytes(_make_edf_bytes([arr]))
    return [lambda io: io.EdfFile(p).GetRegion(0, (3, 2), (5, 7)),
            lambda io: io.EdfFile(p).GetRegion(0, (14, 0), (5, 5)),
            lambda io: io.EdfFile(p).GetRegion(0, (0, 0), (0, 3)),
            lambda io: io.EdfFile(p).GetRegion(2, (0, 0), (1, 1))]


def _edf_wrapped_tiff(d):
    img = (np.arange(48, dtype=np.uint16) * 100).reshape(6, 8)
    jio.save_tiff(img, d / "tmp.tif")
    p = d / "marccd_like.edf"
    p.write_bytes((d / "tmp.tif").read_bytes())
    return [lambda io: io.read_edf(str(p)), lambda io: io.read_edf(str(p), index=3),
            lambda io: io.read_image(str(p))]


def _cbf_spe(d):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 70000, size=(23, 17)).astype(np.int64)
    img[4, 5], img[4, 6] = 0, 1_000_000  # a big negative delta, then the int32 escape
    cbf, spe, edf_in_cbf = d / "frame.cbf", d / "frame.spe", d / "really_edf.cbf"
    _WRAP._write_cbf(cbf, img)
    _WRAP._write_spe(spe, rng.integers(0, 65535, size=(11, 9)).astype(np.uint16))
    jio.save_edf(np.arange(20, dtype=np.float32).reshape(4, 5), str(edf_in_cbf))
    short, nomagic = d / "short.spe", d / "nomagic.cbf"
    short.write_bytes(b"\x00" * 100)
    nomagic.write_bytes(b"###CBF: no binary section")
    return [lambda io: io.read_edf(str(cbf)), lambda io: io.read_edf(str(spe)),
            lambda io: io.read_edf(str(spe), index=1), lambda io: io.read_edf(str(edf_in_cbf)),
            lambda io: io.read_image(str(spe), verbose=False), lambda io: io.read_image(str(cbf)),
            lambda io: io.read_edf(str(short)), lambda io: io.read_edf(str(nomagic))]


def _fixtures(_d):
    u16, f32, gz = DATA / "fixture_u16.edf", DATA / "fixture_f32.edf", DATA / "fixture_u16.edf.gz"
    return [lambda io: io.EdfFile(u16).NumImages, lambda io: io.EdfFile(u16).GetData(0),
            lambda io: io.EdfFile(u16).GetData(1), lambda io: io.EdfFile(u16).GetHeader(1),
            lambda io: io.EdfFile(f32).GetData(0), lambda io: io.EdfFile(gz).GetData(1),
            lambda io: io.EdfFile(u16).GetRegion(0, (5, 3), (10, 17)),
            lambda io: io.read_edf(str(DATA / "fixture.spe")),
            lambda io: io.read_edf(str(DATA / "fixture.cbf")),
            lambda io: io.read_image(str(u16)), lambda io: io.read_image(str(gz)),
            lambda io: io.read_image(str(DATA / "fixture.cbf"))]


def _tiff(d):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 60000, size=(32, 40)).astype(np.uint16)
    stack = rng.integers(0, 60000, size=(3, 16, 16)).astype(np.uint16)
    dark = np.full((16, 20), 7.25, np.float32) + np.linspace(0, 0.5, 20, dtype=np.float32)
    jio.save_tiff(img, d / "img.tif")
    jio.save_tiff(stack, d / "s.tif")
    jio.save_tiff(dark, d / "dark.tiff", dtype="float32")
    files = [str(d / f"s_{i:04d}.tif") for i in range(3)]
    return [lambda io: io.read_image(str(d / "img.tif")), lambda io: io.read_tiff(str(d / "img.tif")),
            lambda io: io.read_image(files), lambda io: io.read_tiff(files),
            lambda io: io.read_image(str(d / "dark.tiff")),
            lambda io: io.read_tiff([files[0], str(d / "img.tif")]),
            lambda io: io.read_tiff([]), lambda io: io.read_tiff(3), lambda io: io.read_tiff([3]),
            lambda io: io.read_image(files, mean=True)]


def _h5(d):
    rng = np.random.default_rng(3)
    stack = rng.normal(size=(4, 8, 8)).astype(np.float32)
    jio.save_h5(stack, d / "d.h5")
    jio.save_h5(np.zeros((2, 4, 4), np.float32), d / "a.h5")
    jio.save_h5(np.ones((3, 4, 4), np.uint16), d / "b.hdf5")
    jio.save_h5(stack[0], d / "two_d.h5")
    jio.save_h5(stack[1], d / "two_e.h5")
    (d / "not.h5").write_bytes(b"not an hdf5 file")
    import h5py

    with h5py.File(d / "empty.h5", "w") as f:
        f.create_group("entry_0000")
    with h5py.File(d / "four_d.h5", "w") as f:
        f.create_dataset(jio.h5.DATASET_PATH, data=np.zeros((1, 2, 3, 4)))
    p = str(d / "d.h5")
    a, b = str(d / "a.h5"), str(d / "b.hdf5")
    return [lambda io: io.read_h5(p), lambda io: io.read_h5(p, image_number=2),
            lambda io: io.read_h5(p, image_number=-1), lambda io: io.read_h5(p, image_number=10),
            lambda io: io.read_h5([a, b]), lambda io: io.read_image([a, b]),
            lambda io: io.read_h5([str(d / "two_d.h5"), str(d / "two_e.h5")]),
            lambda io: io.read_h5([a, str(d / "two_d.h5")]), lambda io: io.read_h5([a, p]),
            lambda io: io.read_h5(str(d / "two_d.h5"), image_number=0),
            lambda io: io.read_h5([a, b], image_number=0), lambda io: io.read_h5([]),
            lambda io: io.read_h5(str(d / "nope.h5")), lambda io: io.read_h5(str(d / "empty.h5")),
            lambda io: io.read_h5(str(d / "four_d.h5")), lambda io: io.read_h5(str(d / "not.h5")),
            lambda io: io.read_image(p, mean=True), lambda io: io.read_image(p, image_number=1),
            lambda io: io.save_h5(stack, d / "d.h5"), lambda io: io.h5.DATASET_PATH]


def _dispatch(d):
    img = np.ones((8, 8), dtype=np.uint16)
    jio.save_tiff(img, d / "x.tif")
    p = str(d / "x.tif")
    return [lambda io: io.write_image(img, d / "x.edf"), lambda io: io.read_image(str(d / "x.png")),
            lambda io: io.write_image(img, d / "x.png"), lambda io: io.read_image(str(d / "noext")),
            lambda io: io.read_image([p, str(d / "y.edf")]), lambda io: io.read_image(p, image_number=0),
            lambda io: io.read_image([p, p], image_number=0), lambda io: io.read_image([]),
            lambda io: io.read_image(5), lambda io: io.write_image([[1]], d / "l.tif"),
            lambda io: io.read_image(str(d / "x.dat"), file_extension=".TIF"),
            lambda io: io.read_image(p, file_extension="tif")]


_READER_CASES = {
    "edf_single": _edf_single, "edf_multi_float": _edf_multi_float, "edf_gzip_bz2": _edf_gzip_bz2,
    "edf_sequence": _edf_sequence, "edf_512_header": _edf_512, "edf_big_endian": _edf_big_endian,
    "edf_corrupt": _edf_corrupt, "edf_oversized_size": _edf_oversized_size,
    "edf_region": _edf_region, "edf_wrapped_tiff": _edf_wrapped_tiff, "cbf_spe": _cbf_spe,
    "fixtures": _fixtures, "tiff": _tiff, "h5": _h5, "dispatch": _dispatch,
}


@pytest.mark.parametrize("case", sorted(_READER_CASES))
def test_readers_equal_jax(case, tmp_path):
    calls = _READER_CASES[case](tmp_path)
    for i, call in enumerate(calls):
        try:
            same(call)
        except AssertionError as exc:
            raise AssertionError(f"{case}: call {i}: {exc}") from exc


def test_fixtures_hold_their_expected_pixels():
    """The committed fixtures decode to the pixels stored beside them (no
    code of either package wrote these files)."""
    expected = np.load(DATA / "fixture_u16_expected.npy")
    e = tio.EdfFile(DATA / "fixture_u16.edf")
    assert e.NumImages == 2 and e.GetHeader(1).get("frame") == "1"
    for i in range(2):
        assert e.GetData(i).dtype == np.uint16
        np.testing.assert_array_equal(e.GetData(i), expected[i])
    np.testing.assert_array_equal(tio.EdfFile(DATA / "fixture_f32.edf").GetData(0),
                                  np.load(DATA / "fixture_f32_expected.npy"))
    for name in ("spe", "cbf"):
        want = np.load(DATA / f"fixture_{name}_expected.npy")
        got = tio.read_edf(str(DATA / f"fixture.{name}"))
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_cbf_int64_escape_equals_jax():
    big = 2**31 + 5
    esc = struct.pack("<b", -128) + struct.pack("<h", -32768) + struct.pack("<i", -(2**31))
    stream = (struct.pack("<b", 10) + esc + struct.pack("<q", big) + struct.pack("<b", -3)
              + esc + struct.pack("<q", -big) + struct.pack("<b", 1))
    got = tedf._byte_offset_decode(stream, 5)
    np.testing.assert_array_equal(got, jedf._byte_offset_decode(stream, 5))
    np.testing.assert_array_equal(got, np.cumsum([10, big, -3, -big, 1]))
    for cut in (2, 5, 9):  # truncated inside each escape level
        with pytest.raises(ValueError) as want:
            jedf._byte_offset_decode(stream[:cut], 5)
        with pytest.raises(ValueError, match=str(want.value)):
            tedf._byte_offset_decode(stream[:cut], 5)


def test_read_image_verbose_prints_as_jax(tmp_path, capsys):
    jio.save_h5(np.zeros((2, 4, 4), np.float32), tmp_path / "v.h5")
    lines = []
    for io in (jio, tio):
        io.read_image(str(tmp_path / "v.h5"), mean=True, verbose=True)
        io.write_image(np.zeros((4, 4), np.uint16), tmp_path / f"{io.__name__}.tif", verbose=True)
        out = capsys.readouterr().out.replace(io.__name__, "pkg").splitlines()
        lines.append([ln for ln in out if "elapsed" not in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 3


# -- writers, and files crossing between the packages ---------------------------

_EDF_DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.int32, np.uint32, np.int64, np.uint64,
               np.float32, np.float64]


def _values(dtype, shape, seed=8):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -(2**31)), min(info.max, 2**31 - 1), size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", _EDF_DTYPES, ids=lambda d: np.dtype(d).name)
def test_save_edf_bytes_equal_and_cross_read(tmp_path, dtype):
    arr = _values(dtype, (13, 17))
    stack = _values(dtype, (3, 5, 7), seed=9)
    for name, data in (("one", arr), ("stack", stack), ("be", arr.astype(arr.dtype.newbyteorder(">")))):
        pj, pt = tmp_path / f"{name}_j.edf", tmp_path / f"{name}_t.edf"
        jio.save_edf(data, pj)
        tio.save_edf(data, pt)
        assert pj.read_bytes() == pt.read_bytes()
        for writer_file, reader in ((pj, tio), (pt, jio)):
            f = reader.EdfFile(writer_file)
            frames = data[None] if data.ndim == 2 else data
            assert f.NumImages == len(frames)
            for i, frame in enumerate(frames):
                got = f.GetData(i)
                assert got.dtype == np.dtype(dtype).newbyteorder("<")
                np.testing.assert_array_equal(got, frame)


def test_save_edf_validation_equals_jax(tmp_path):
    for call in (lambda io: io.save_edf([[1, 2]], tmp_path / "x.edf"),
                 lambda io: io.save_edf(np.zeros(4), tmp_path / "x.edf"),
                 lambda io: io.save_edf(np.zeros((4, 4)), tmp_path / "missing" / "x.edf"),
                 lambda io: io.save_edf(np.zeros((4, 4), dtype=np.complex64), tmp_path / "x.edf")):
        assert same(call) is None  # each raises, alike


_TIFF_CASES = {
    "uint16_2d": (lambda: _values(np.uint16, (32, 40)), "uint16"),
    "uint16_stack": (lambda: _values(np.uint16, (3, 16, 16)), "uint16"),
    "counts_float": (lambda: np.abs(_values(np.float32, (24, 24))) * 3000 + 50, "uint16"),
    "normalised_float": (lambda: np.abs(_values(np.float64, (24, 24))), "uint16"),
    "float32_2d": (lambda: _values(np.float32, (16, 20)), "float32"),
    "float32_stack": (lambda: _values(np.float64, (2, 16, 20)), "float32"),
}


@pytest.mark.parametrize("case", sorted(_TIFF_CASES))
def test_save_tiff_cross_read(tmp_path, case):
    make, dtype = _TIFF_CASES[case]
    data = make()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jio.save_tiff(data, tmp_path / "j" / "w.tif", dtype=dtype)
    tio.save_tiff(data, tmp_path / "t" / "w", dtype=dtype, device="cpu")  # suffix added
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == (1 if data.ndim == 2 else len(data))
    for name in names:
        from_j = tio.read_tiff(str(tmp_path / "j" / name))
        from_t = jio.read_tiff(str(tmp_path / "t" / name))
        assert from_j.dtype == from_t.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(from_j, from_t)
    if case.startswith(("uint16", "float32")):
        got = tio.read_image([str(tmp_path / "j" / n) for n in names])
        np.testing.assert_array_equal(got[0] if data.ndim == 2 else got, data.astype(dtype))


def test_save_tiff_validation_equals_jax(tmp_path):
    img = np.zeros((4, 4), np.uint16)
    (tmp_path / "file").write_text("x")
    for call in (lambda io: io.save_tiff([[1]], tmp_path / "x.tif"),
                 lambda io: io.save_tiff(np.zeros(4), tmp_path / "x.tif"),
                 lambda io: io.save_tiff(img, tmp_path / "x.tif", dtype="int8"),
                 lambda io: io.save_tiff(img, tmp_path / "missing" / "x.tif"),
                 lambda io: io.save_tiff(img, tmp_path / "file" / "x.tif"),
                 lambda io: io.save_tiff(img, "")):
        assert same(call) is None


@pytest.mark.parametrize("writer, reader", [(jio, tio), (tio, jio)], ids=["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.float64], ids=lambda d: np.dtype(d).name)
def test_save_h5_cross_read(tmp_path, writer, reader, dtype):
    stack = _values(dtype, (4, 8, 8))
    writer.save_h5(stack, tmp_path / "d")  # .h5 is appended
    writer.write_image(stack[0], tmp_path / "one.hdf5")
    got = reader.read_h5(str(tmp_path / "d.h5"))
    assert got.dtype == stack.dtype
    np.testing.assert_array_equal(got, stack)
    np.testing.assert_array_equal(reader.read_image(str(tmp_path / "d.h5"), image_number=-1), stack[3])
    np.testing.assert_array_equal(reader.read_image(str(tmp_path / "one.hdf5")), stack[0])
    import h5py

    with h5py.File(tmp_path / "d.h5", "r") as f:
        assert f["entry_0000"].attrs["NX_class"] == "NXentry"
        assert f["entry_0000/measurement"].attrs["NX_class"] == "NXcollection"
        assert f[reader.h5.DATASET_PATH].compression == "gzip"
    with pytest.raises(OSError, match="refusing to overwrite"):
        writer.save_h5(stack, tmp_path / "d.h5")


def test_save_h5_validation_equals_jax(tmp_path):
    (tmp_path / "file").write_text("x")
    for call in (lambda io: io.save_h5([[1]], tmp_path / "x.h5"),
                 lambda io: io.save_h5(np.zeros(4), tmp_path / "x.h5"),
                 lambda io: io.save_h5(np.zeros((4, 4)), tmp_path / "missing" / "x.h5"),
                 lambda io: io.save_h5(np.zeros((4, 4)), tmp_path / "file" / "x.h5"),
                 lambda io: io.save_h5(np.zeros((4, 4)), "")):
        assert same(call) is None


# -- the optional packages --------------------------------------------------------

def test_package_exports_equal_jax():
    assert sorted(tio.__all__) == sorted(jio.__all__)
    import barc4dip_tpu_torch as port

    assert port.read_image is tio.read_image and port.write_image is tio.write_image
    assert tio.uti_EdfFile.EdfFile is tio.EdfFile


@pytest.mark.parametrize("hidden", ["h5py", "PIL"])
def test_a_missing_optional_package_is_named(tmp_path, monkeypatch, hidden):
    """EDF reads and writes need neither package; the call that needs the
    hidden one raises an ImportError that names it."""
    jio.save_h5(np.zeros((2, 4, 4), np.float32), tmp_path / "d.h5")
    jio.save_tiff(np.ones((4, 4), np.uint16), tmp_path / "x.tif")
    monkeypatch.setitem(sys.modules, hidden, None)
    arr = np.arange(12, dtype=np.uint16).reshape(3, 4)
    tio.save_edf(arr, tmp_path / "a.edf")
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "a.edf")), arr)
    if hidden == "h5py":
        with pytest.raises(ImportError, match="h5py"):
            tio.read_image(str(tmp_path / "d.h5"))
        with pytest.raises(ImportError, match="h5py"):
            tio.save_h5(arr, tmp_path / "new.h5")
        np.testing.assert_array_equal(tio.read_image(str(tmp_path / "x.tif")), 1)
    else:
        with pytest.raises(ImportError, match="Pillow"):
            tio.read_image(str(tmp_path / "x.tif"))
        with pytest.raises(ImportError, match="Pillow"):
            tio.save_tiff(arr, tmp_path / "new.tif")
        assert tio.read_image(str(tmp_path / "d.h5")).shape == (2, 4, 4)
