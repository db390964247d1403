"""Training previews and structured metrics — counterpart of
``mpgan_tpu/utils/preview.py``.

A [input | generated | target] patch grid PNG, mid-slice PNGs of volumes,
and a metrics appender (``metrics.csv`` + ``metrics.jsonl``, mirrored to
TensorBoard events in ``<run>/tb/`` when a ``SummaryWriter`` imports; JAX
``:72-118``). PNGs are 8-bit grayscale, written by a small encoder on
``zlib`` and ``struct`` (no imaging package is needed), atomically.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import zlib

import numpy as np


def norm_u8(img: np.ndarray, peak: float | None = None) -> np.ndarray:
    """A float image → uint8 over [0, peak] (peak: the image's maximum when
    None; an explicit 0.0 keeps a shared scale)."""
    if peak is None:
        peak = float(img.max())
    return np.clip(img * 255.0 / max(peak, 1e-6), 0, 255).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W) uint8 image → the bytes of an 8-bit grayscale PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"need an (H, W) image, got shape {img.shape}")
    h, w = img.shape
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG that :func:`encode_png` wrote → its (H, W) uint8
    image (8-bit grayscale, unfiltered scanlines only)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    if (depth, color) != (8, 0):
        raise ValueError(f"not 8-bit grayscale: depth {depth}, color {color}")
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError("filtered scanlines are not supported")
    return rows[:, 1:].copy()


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as a PNG, atomically (tmp + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(encode_png(img))
    os.replace(path + ".tmp", path)


def save_patch_grid(path: str, columns: list[np.ndarray],
                    max_rows: int = 4) -> None:
    """A grid PNG: one column per (B, H, W, 1) array, one row per batch
    element (the first ``max_rows``), every column scaled up (nearest) to
    the tallest one and all on one shared scale, y up."""
    cols = [np.asarray(c, dtype=np.float32)[..., 0] for c in columns]
    n = min(max_rows, min(c.shape[0] for c in cols))
    hmax = max(c.shape[1] for c in cols)
    peak = max(float(c.max()) for c in cols)
    rows = []
    for i in range(n):
        row = []
        for c in cols:
            img = c[i]
            fh, fw = hmax // img.shape[0], hmax // img.shape[1]
            if fh > 1 or fw > 1:
                img = np.repeat(np.repeat(img, max(fh, 1), 0), max(fw, 1), 1)
            row.append(norm_u8(img[::-1], peak))
        rows.append(np.concatenate(row, axis=1))
    save_png(path, np.concatenate(rows, axis=0))


def save_volume_slices(path: str, vol: np.ndarray, axis: int = 2) -> None:
    """Mid-slice preview of a (Z, Y, X, 1) volume along ``axis``."""
    v = np.asarray(vol, dtype=np.float32)[..., 0]
    sl = np.take(v, v.shape[axis] // 2, axis=axis)
    save_png(path, norm_u8(sl[::-1]))


def summary_writer_class():
    """torch's TensorBoard ``SummaryWriter``, else tensorboardX's, else
    None (the bare ``tensorboard`` package only reads events)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter


class MetricsWriter:
    """Appends rows to ``metrics.csv`` and ``metrics.jsonl`` in a run dir,
    and mirrors the scalars to TensorBoard when a ``SummaryWriter``
    (torch's, else tensorboardX's) imports; ``it`` is the step."""

    def __init__(self, run_dir: str):
        self.csv_path = os.path.join(run_dir, "metrics.csv")
        self.jsonl_path = os.path.join(run_dir, "metrics.jsonl")
        self._fields: list[str] | None = None
        writer = summary_writer_class()
        self._tb = writer(os.path.join(run_dir, "tb")) if writer else None

    def write(self, row: dict) -> None:
        if self._tb is not None:
            step = int(row.get("it", 0))
            for k, v in row.items():
                if k != "it" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, float(v), global_step=step)
            self._tb.flush()
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        new = self._fields is None
        if new:
            self._fields = sorted(row)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields,
                               extrasaction="ignore")
            if new and f.tell() == 0:
                w.writeheader()
            w.writerow(row)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
