"""Mantaflow ``.uni`` volume I/O.

A ``.uni`` file is a single gzip stream containing a 4-byte magic ID
(``MNT2`` old / ``MNT3`` current), a 288-byte packed header, then the raw
grid data (little-endian float32/int32, C order, shape (T)ZYX[C]).

Header layouts (matching the tempoGAN-family Python tooling, which is what
the reference's ``uniio.py`` uses — SURVEY.md §2.3; reference mount was empty
at survey time so struct layouts follow the upstream tempoGAN ``uniio.py``
conventions):

    MNT2: struct.unpack('iiiiii256sQ',  288 bytes)
          dimX dimY dimZ gridType elementType bytesPerElement info[256] timestamp
    MNT3: struct.unpack('iiiiii252siQ', 288 bytes)
          dimX dimY dimZ gridType elementType bytesPerElement info[252] dimT timestamp

Element types: 0 = int32, 1 = float32 (Real), 2 = vec3 (3×float32).
Grid-type bits (mantaflow GridBase::GridType): TypeNone=0 TypeReal=1 TypeInt=2
TypeVec3=4 TypeMAC=8 TypeLevelset=16 TypeFlags=32.

Arrays are returned/accepted with shape ``(dimZ, dimY, dimX, channels)``
(channels 1 or 3), matching the layout the reference's tile creator consumes.

A copy of the pure-Python codec in ``mpgan_tpu/io/uni.py``: the port imports
nothing of the JAX package. The loader and ``read_uni_volume`` decode with
the port's native C++ codec (:mod:`mpgan_torch.io.native`) when it builds,
and with this module otherwise; the datagen writers are this module's.
"""

from __future__ import annotations

import gzip
import os
import struct
import time
from typing import Any

import numpy as np

_HDR_MNT2 = "iiiiii256sQ"
_HDR_MNT3 = "iiiiii252siQ"
_HDR_BYTES = 288

# mantaflow GridBase::GridType bits
TYPE_NONE = 0
TYPE_REAL = 1
TYPE_INT = 2
TYPE_VEC3 = 4
TYPE_MAC = 8
TYPE_LEVELSET = 16
TYPE_FLAGS = 32

ELEM_INT = 0
ELEM_REAL = 1
ELEM_VEC3 = 2


def _read_header(stream) -> dict[str, Any]:
    magic = stream.read(4)
    if magic == b"MNT2":
        fields = struct.unpack(_HDR_MNT2, stream.read(_HDR_BYTES))
        head = dict(
            zip(
                ("dimX", "dimY", "dimZ", "gridType", "elementType",
                 "bytesPerElement", "info", "timestamp"),
                fields,
            )
        )
        head["dimT"] = 0
    elif magic == b"MNT3":
        fields = struct.unpack(_HDR_MNT3, stream.read(_HDR_BYTES))
        head = dict(
            zip(
                ("dimX", "dimY", "dimZ", "gridType", "elementType",
                 "bytesPerElement", "info", "dimT", "timestamp"),
                fields,
            )
        )
    else:
        raise ValueError(f"not a MNT2/MNT3 .uni file (magic={magic!r})")
    head["magic"] = magic.decode("ascii")
    return head


def _read_content(stream, head: dict[str, Any]) -> np.ndarray:
    elem = head["elementType"]
    bpe = head["bytesPerElement"]
    if not ((elem == ELEM_VEC3 and bpe == 12) or (elem in (ELEM_INT, ELEM_REAL) and bpe == 4)):
        raise ValueError(f"unsupported elementType={elem} bytesPerElement={bpe}")
    dtype = np.int32 if elem == ELEM_INT else np.float32
    data = np.frombuffer(stream.read(), dtype=dtype)
    channels = 3 if elem == ELEM_VEC3 else 1
    dim_t = max(head.get("dimT", 0), 0)
    if dim_t > 1:  # 4D grid
        shape = (dim_t, head["dimZ"], head["dimY"], head["dimX"], channels)
    else:
        shape = (head["dimZ"], head["dimY"], head["dimX"], channels)
    return data.reshape(shape, order="C")


def read_gridtype(path: str) -> int:
    """Cheap header peek: the gridType bitfield without decoding the grid
    (292 compressed bytes). Lets callers gate MAC recentering on TypeMAC
    regardless of which codec decodes the payload."""
    with gzip.open(path, "rb") as f:
        return _read_header(f)["gridType"]


def recenter_mac(vel: np.ndarray) -> np.ndarray:
    """Average staggered MAC face values to cell centers.

    A mantaflow ``MACGrid`` stores component c of cell (k, j, i) on the
    cell's *lower* face along axis c (u at i−½, v at j−½, w at k−½); the
    collocated cell-center value is the mean of the two bounding faces:
    ``0.5 * (v_c[idx] + v_c[idx + e_c])``, clamped at the upper domain edge.
    The upstream tempoGAN-family ``uniio.py`` skips this and feeds MAC data
    to the models as if collocated (SURVEY.md §2.3 "Verify"); pass
    ``recenter_mac=True`` to :func:`readUni` to close that half-cell offset.
    """
    if vel.ndim != 4 or vel.shape[-1] != 3:
        raise ValueError(f"expected (Z,Y,X,3) velocity, got {vel.shape}")
    out = np.empty_like(vel)
    for axis, comp in ((2, 0), (1, 1), (0, 2)):  # vx→X axis, vy→Y, vz→Z
        v = vel[..., comp]
        idx = np.arange(1, v.shape[axis] + 1)
        idx[-1] = v.shape[axis] - 1  # clamp upper edge
        out[..., comp] = 0.5 * (v + v.take(idx, axis=axis))
    return out


def readUni(path: str, recenter: bool = False
            ) -> tuple[dict[str, Any], np.ndarray]:
    """Read a .uni file → (header dict, array of shape (Z, Y, X, C)).

    ``recenter=True`` converts staggered MAC velocity grids (gridType has
    the TypeMAC bit, vec3 elements) to cell-centered values via
    :func:`recenter_mac`; other grids are returned unchanged.
    """
    with gzip.open(path, "rb") as f:
        head = _read_header(f)
        arr = _read_content(f, head)
    if recenter and head["elementType"] == ELEM_VEC3 \
            and head["gridType"] & TYPE_MAC and arr.ndim == 4:
        arr = recenter_mac(arr)
    return head, arr


def make_header(
    arr: np.ndarray,
    grid_type: int | None = None,
    info: bytes = b"mpgan_torch",
    timestamp: int | None = None,
) -> dict[str, Any]:
    """Build an MNT3 header dict for an array shaped (Z, Y, X, C)."""
    if arr.ndim != 4:
        raise ValueError(f"expected (Z,Y,X,C) array, got shape {arr.shape}")
    z, y, x, c = arr.shape
    if c == 1:
        elem, bpe = (ELEM_INT, 4) if np.issubdtype(arr.dtype, np.integer) else (ELEM_REAL, 4)
        gt = grid_type if grid_type is not None else (TYPE_INT if elem == ELEM_INT else TYPE_REAL)
    elif c == 3:
        elem, bpe = ELEM_VEC3, 12
        # default to plain Vec3 (cell-centered): the TypeMAC bit is a claim
        # about STAGGERED lower-face storage, and readers gate recentering on
        # it — callers writing true mantaflow MAC data must say so explicitly
        gt = grid_type if grid_type is not None else TYPE_VEC3
    else:
        raise ValueError(f"channels must be 1 or 3, got {c}")
    return dict(
        dimX=x, dimY=y, dimZ=z,
        gridType=gt, elementType=elem, bytesPerElement=bpe,
        info=info[:252].ljust(252, b"\x00"),
        dimT=0,
        timestamp=timestamp if timestamp is not None else int(time.time() * 1e6),
    )


def writeUni(path: str, head: dict[str, Any], arr: np.ndarray) -> None:
    """Write (header, (Z,Y,X,C) array) as an MNT3 .uni gzip stream."""
    elem = head["elementType"]
    dtype = np.int32 if elem == ELEM_INT else np.float32
    arr = np.ascontiguousarray(arr, dtype=dtype)
    info = head["info"]
    if isinstance(info, str):
        info = info.encode("ascii", "replace")
    info = info[:252].ljust(252, b"\x00")
    packed = struct.pack(
        _HDR_MNT3,
        head["dimX"], head["dimY"], head["dimZ"],
        head["gridType"], head["elementType"], head["bytesPerElement"],
        info, int(head.get("dimT", 0)), int(head["timestamp"]),
    )
    n = head["dimX"] * head["dimY"] * head["dimZ"] * max(int(head.get("dimT", 0)), 1)
    c = 3 if elem == ELEM_VEC3 else 1
    flat = arr.reshape(-1)
    if flat.size != n * c:
        raise ValueError(f"array size {flat.size} != header dims {n}*{c}")
    # Atomic write (tmp + rename): a crash mid-write must never leave a
    # truncated .uni behind — restart logic (writeTest resume, datagen
    # skip-existing) treats an existing file as complete.
    tmp = path + ".tmp"
    with gzip.open(tmp, "wb", compresslevel=1) as f:
        f.write(b"MNT3")
        f.write(packed)
        f.write(memoryview(flat))
    os.replace(tmp, path)


# snake_case aliases: the upstream tooling spells these camelCase
# (readUni/writeUni); both spellings are documented in docs/MIGRATION.md
read_uni = readUni
write_uni = writeUni


def write_density(path: str, dens: np.ndarray) -> None:
    """Convenience: write a (Z,Y,X) or (Z,Y,X,1) density volume."""
    if dens.ndim == 3:
        dens = dens[..., None]
    writeUni(path, make_header(dens, grid_type=TYPE_REAL), dens)


def write_velocity(path: str, vel: np.ndarray) -> None:
    """Convenience: write a (Z,Y,X,3) velocity volume (stored collocated).

    The header is plain TypeVec3, NOT TypeMAC: the in-repo solver's values
    are not mantaflow lower-face staggered data, and setting the MAC bit
    would make ``macRecenter 1`` apply a wrong half-cell shift to
    self-generated datasets (readers gate recentering on that bit)."""
    writeUni(path, make_header(vel, grid_type=TYPE_VEC3), vel)
