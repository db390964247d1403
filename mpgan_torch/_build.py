"""Build the port's native libraries at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with nvcc into ``mpgan_torch/_build/lib<name>-<hash>.so`` (the hash is of
the source and the flags, so an edited source is rebuilt), then loaded with
``ctypes``. No PyTorch header is included, which keeps a build to seconds.
Builds of several sources start together and run in parallel.

Host-only C++ sources, ``csrc/<name>.cpp`` (the ``.uni`` codec), take the
second recipe, :func:`build_host`: g++ with the libraries of
:data:`HOST_LIBS`, into the same directory under the same naming.

Nothing here runs at import: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
# host source -> the libraries it links
HOST_LIBS = {"uni_native": ["-lz"]}

# ctypes signatures of each library's entry points:
# name -> {function: (restype, [argtypes])}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "warp": {
        "mpgan_warp2d": (_I, [_P, _P, _P, _I, _I, _I, _F, _F, _I, _P]),
        "mpgan_warp2d_triplet": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                      _I, _P]),
        "mpgan_warp2d_bwd": (_I, [_P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _F, _F, _I, _P]),
        "mpgan_warp2d_triplet_bwd": (_I, [_P, _L, _L, _L, _L, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                          _P]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return str(path)


def _lib_path(name: str, ext: str = ".cu", flags=NVCC_FLAGS) -> Path:
    src = (CSRC_DIR / f"{name}{ext}").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_host(name: str) -> Path:
    """Compile the host-only ``csrc/<name>.cpp`` with g++ (if it has no
    up-to-date library yet) → its library path. Raises ``RuntimeError``
    with g++'s output when the compile fails and ``OSError`` when there is
    no g++; the library appears by ``os.replace`` of a temporary file, so
    that no process loads half of one."""
    libs = HOST_LIBS[name]
    path = _lib_path(name, ".cpp", GXX_FLAGS + libs)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(CSRC_DIR / f"{name}.cpp"),
                            "-o", str(tmp), *libs],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"g++ {name}.cpp failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def build(names=None) -> dict[str, Path]:
    """Compile every named source (default: all of :data:`SIGNATURES`)
    that has no up-to-date library yet, all nvcc processes at once.
    Returns name → library path; raises with nvcc's output on failure."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
