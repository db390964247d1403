"""The port's native .uni codec (mpgan_torch/csrc/uni_native.cpp through
mpgan_torch.io.native) on the CPU: mirrors tests/test_native.py, and holds
the codec against the port's pure-Python codec, against the JAX package's
native codec on examples/data/, and the port's loader with and without it.
Every comparison is exact: a codec moves bytes.
"""

import glob
import os

import numpy as np
import pytest
import torch

from mpgan_torch import _build
from mpgan_torch.data import loader as tloader
from mpgan_torch.infer import load as tload
from mpgan_torch.io import native, uni
from mpgan_tpu.data import loader as jloader
from mpgan_tpu.io import native as jnative

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "examples", "data")


def test_library_is_the_ports_own_build():
    """g++ and zlib are on this machine: the codec builds, into the port's
    _build directory, never from native/ (the JAX package's file)."""
    lib = native.get_lib()
    assert lib is not None and native.available()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == str(_build.BUILD_DIR.resolve())
    assert os.path.basename(path).startswith("libuni_native-")
    assert not path.startswith(os.path.join(ROOT, "native"))


def test_no_toolchain_falls_back_to_python(monkeypatch, tmp_path):
    def no_gxx(name):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_gxx)
    assert native.get_lib() is None and not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.read(str(tmp_path / "x.uni"))
    d = np.random.default_rng(0).random((3, 4, 5, 1), dtype=np.float32)
    p = str(tmp_path / "d.uni")
    uni.write_density(p, d[..., 0])
    np.testing.assert_array_equal(tload.read_uni_volume(p), d)


def test_native_reads_python_written(tmp_path):
    d = np.random.default_rng(0).random((10, 8, 6, 1), dtype=np.float32)
    p = str(tmp_path / "d.uni")
    uni.write_density(p, d[..., 0])
    np.testing.assert_array_equal(native.read(p), d)
    h = native.read_header(p)
    assert (h["dimZ"], h["dimY"], h["dimX"], h["channels"]) == (10, 8, 6, 1)
    assert h["gridType"] == uni.TYPE_REAL and h["dimT"] == 0


def test_python_reads_native_written_mac_vec3(tmp_path):
    v = np.random.default_rng(1).standard_normal((5, 6, 7, 3)).astype(
        np.float32)
    p = str(tmp_path / "v.uni")
    native.write(p, v, grid_type=uni.TYPE_MAC | uni.TYPE_VEC3,
                 element_type=uni.ELEM_VEC3)
    head, got = uni.readUni(p)
    assert head["elementType"] == uni.ELEM_VEC3
    assert head["gridType"] == uni.TYPE_MAC | uni.TYPE_VEC3
    assert head["info"].rstrip(b"\0") == b"mpgan_torch"
    np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(native.read(p), v)
    assert native.read_gridtype(p) == uni.read_gridtype(p) \
        == uni.TYPE_MAC | uni.TYPE_VEC3
    # recentred on the MAC bit, exactly as the pure-Python reader does
    np.testing.assert_array_equal(tload.read_uni_volume(p, mac_recenter=True),
                                  uni.readUni(p, recenter=True)[1])


def test_native_roundtrip_int(tmp_path):
    flags = np.arange(24, dtype=np.int32).reshape(2, 3, 4, 1)
    p = str(tmp_path / "f.uni")
    native.write(p, flags, grid_type=uni.TYPE_FLAGS,
                 element_type=uni.ELEM_INT)
    got = native.read(p)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, flags)
    np.testing.assert_array_equal(uni.readUni(p)[1], flags)


def test_native_reads_4d_grid(tmp_path):
    """dimT > 1: a (T, Z, Y, X, C) grid, as the pure-Python codec reads it."""
    a = np.random.default_rng(2).random((3, 4, 5, 6, 1), dtype=np.float32)
    head = uni.make_header(a[0])
    head["dimT"] = 3
    p = str(tmp_path / "t.uni")
    uni.writeUni(p, head, a)
    assert native.read_header(p)["dimT"] == 3
    np.testing.assert_array_equal(native.read(p), a)
    np.testing.assert_array_equal(native.read(p), uni.readUni(p)[1])


def test_write_is_atomic(tmp_path):
    """A write goes through a temporary file and os.replace: nothing but the
    finished file remains, an overwrite replaces it whole, and a write that
    cannot open its file raises and leaves nothing behind."""
    p = str(tmp_path / "d.uni")
    for seed in (0, 1):
        d = np.random.default_rng(seed).random((4, 4, 4, 1), dtype=np.float32)
        native.write(p, d, uni.TYPE_REAL, uni.ELEM_REAL)
        assert os.listdir(tmp_path) == ["d.uni"]
        np.testing.assert_array_equal(native.read(p), d)
    bad = str(tmp_path / "no_such_dir" / "d.uni")
    with pytest.raises(IOError):
        native.write(bad, d, uni.TYPE_REAL, uni.ELEM_REAL)
    assert os.listdir(tmp_path) == ["d.uni"]


def test_read_many_parallel(tmp_path):
    rng = np.random.default_rng(2)
    paths, arrays = [], []
    for i in range(12):
        a = rng.random((6, 6, 6, 1), dtype=np.float32)
        p = str(tmp_path / f"d{i}.uni")
        uni.write_density(p, a[..., 0])
        paths.append(p)
        arrays.append(a)
    for g, a in zip(native.read_many(paths, workers=6), arrays):
        np.testing.assert_array_equal(g, a)


def test_bad_file_raises(tmp_path):
    p = str(tmp_path / "junk.uni")
    with open(p, "wb") as f:
        f.write(b"not gzip at all")
    with pytest.raises(IOError):
        native.read(p)
    with pytest.raises(IOError):
        native.read_header(str(tmp_path / "missing.uni"))


def test_agrees_with_jax_native_on_examples():
    """Every bundled frame: the port's native read, the JAX package's native
    read and the port's pure-Python read give one array and one header."""
    paths = sorted(glob.glob(os.path.join(DATA, "*", "*.uni")))
    assert len(paths) >= 15
    got = native.read_many(paths)
    for p, a in zip(paths, got):
        np.testing.assert_array_equal(a, jnative.read(p))
        np.testing.assert_array_equal(a, uni.readUni(p)[1])
        assert native.read_header(p) == jnative.read_header(p)
        assert native.read_gridtype(p) == jnative.read_gridtype(p)


@pytest.mark.parametrize("mac", [False, True])
def test_loader_same_with_and_without_codec(monkeypatch, tmp_path, mac):
    """The port's loader on sim_3020 frames 29-31 (and on a copy whose
    velocities carry the MAC bit, with macRecenter): the same arrays from
    the native codec, from the pure-Python codec and from the JAX package's
    loader."""
    base, sim = DATA, 3020
    if mac:
        base, sim = str(tmp_path), 1000
        os.makedirs(os.path.join(base, "sim_1000"))
        for f in (29, 30, 31):
            for stem in (tloader.LOW_DENSITY, tloader.HIGH_DENSITY):
                os.symlink(os.path.join(DATA, "sim_3020", stem % f),
                           os.path.join(base, "sim_1000", stem % f))
            v = uni.readUni(os.path.join(DATA, "sim_3020",
                                         tloader.LOW_VELOCITY % f))[1]
            uni.writeUni(os.path.join(base, "sim_1000",
                                      tloader.LOW_VELOCITY % f),
                         uni.make_header(v, uni.TYPE_MAC | uni.TYPE_VEC3), v)

    def load(mod):
        return mod.FluidDataLoader(base, sim, sim, frame_min=29, frame_max=32,
                                   use_vorticities=True,
                                   mac_recenter=mac).get()
    with_codec = load(tloader)
    jax_side = load(jloader)
    monkeypatch.setattr(native, "_lib", False)    # as without a toolchain
    assert not native.available()
    without = load(tloader)
    assert with_codec.lr.shape == (3, 16, 16, 16, 7)
    for ds in (without, jax_side):
        np.testing.assert_array_equal(with_codec.lr, ds.lr)
        np.testing.assert_array_equal(with_codec.hr, ds.hr)
        assert (with_codec.n_frames, with_codec.up_res) == (ds.n_frames,
                                                            ds.up_res)
