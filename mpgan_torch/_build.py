"""Build the port's native libraries at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with nvcc into ``mpgan_torch/_build/lib<name>-<hash>.so`` (the hash is of
the source and the flags, so an edited source is rebuilt), then loaded with
``ctypes``. No PyTorch header is included, which keeps a build to seconds.
Builds of several sources start together and run in parallel.

Host-only C++ sources, ``csrc/<name>.cpp`` (the ``.uni`` codec), take the
second recipe, :func:`build_host`: g++ with the libraries of
:data:`HOST_LIBS`, into the same directory under the same naming.

Operator sources, ``csrc/<name>.cpp`` of :data:`OPS_LIBS` (the warp
forwards), take the third, :func:`build_ops`: g++ against PyTorch's
header-only stable ABI (``torch/csrc/stable``; not ``torch/extension.h``,
whose build takes minutes), linked to the kernel library they launch and to
torch's own libraries; :func:`load_ops` loads the result with
``torch.ops.load_library``, which registers its operators with PyTorch's
dispatcher.

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
# operator source -> the kernel library (csrc/<name>.cu) it links and calls
OPS_LIBS = {"warp_ops": "warp"}

# ctypes signatures of each library's entry points:
# name -> {function: (restype, [argtypes])}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "conv": {
        "mpgan_conv": (_I, [_I, _I, _I, _I, _P, _L, _L, _L, _I, _I, _I, _P,
                            _P, _P, _L, _L, _L, _P, _P, _I, _I, _P, _I, _I,
                            _I, _P]),
    },
    "warp": {
        "mpgan_warp2d": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                              _P]),
        "mpgan_warp2d_triplet": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _F, _I, _P]),
        "mpgan_warp2d_bwd": (_I, [_P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _F, _F, _I, _P]),
        "mpgan_warp2d_triplet_bwd": (_I, [_P, _L, _L, _L, _L, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                          _P]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ops_loaded: dict[str, Path] = {}


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


def _gxx(name: str, flags: list, libs: list, key: str = "") -> Path:
    """Compile ``csrc/<name>.cpp`` with g++ (if it has no up-to-date
    library yet; ``key`` adds to the hash) → its library path. Raises
    ``RuntimeError`` with g++'s output when the compile fails and
    ``OSError`` when there is no g++; the library appears by ``os.replace``
    of a temporary file, so that no process loads half of one."""
    path = _lib_path(name, ".cpp", [*flags, *libs] + ([key] if key else []))
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        r = subprocess.run(["g++", *flags, str(CSRC_DIR / f"{name}.cpp"),
                            "-o", str(tmp), *libs],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"g++ {name}.cpp failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def build_host(name: str) -> Path:
    """Compile the host-only ``csrc/<name>.cpp`` with g++ and the libraries
    of :data:`HOST_LIBS` → its library path (see :func:`_gxx`)."""
    return _gxx(name, GXX_FLAGS, HOST_LIBS[name])


def build_ops(name: str) -> Path:
    """Compile the operator source ``csrc/<name>.cpp`` against PyTorch's
    stable ABI headers, linked to its kernel library (built first, found
    beside it through ``$ORIGIN``) and to torch's ``libtorch_cpu``,
    ``libtorch_cuda`` and ``libc10`` → its library path. The hash covers
    the kernel library's name (so an edited kernel relinks) and torch's
    version."""
    import torch

    kernel = build([OPS_LIBS[name]])[OPS_LIBS[name]]
    tdir = Path(torch.__file__).resolve().parent
    flags = [*GXX_FLAGS, "-std=c++17", "-DUSE_CUDA",
             f"-I{tdir / 'include'}"]
    libs = [f"-L{BUILD_DIR}", f"-l:{kernel.name}", "-Wl,-rpath,$ORIGIN",
            f"-L{tdir / 'lib'}", "-ltorch_cpu", "-ltorch_cuda", "-lc10",
            f"-Wl,-rpath,{tdir / 'lib'}"]
    return _gxx(name, flags, libs, torch.__version__)


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


def load_ops(name: str) -> Path:
    """Build the operator library ``name`` if needed and register its
    operators with PyTorch (once per process) → its path."""
    import torch

    with _lock:
        path = _ops_loaded.get(name)
        if path is None:
            path = build_ops(name)
            torch.ops.load_library(str(path))
            _ops_loaded[name] = path
        return path


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
