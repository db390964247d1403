"""Persistent inference serving over a Unix-domain socket (PyTorch port).

A copy of ``mpgan_tpu/serve.py``'s server, client and wire protocol, with a
torch upscaler: the generators are loaded once and stay resident on the
card, and volume requests are answered over a local socket.

    python -m mpgan_torch.serve weights1 mpgan_torch/weights/g1_l1_4x.npz \
        weights2 mpgan_torch/weights/g2_l1_4x.npz upRes 4 \
        sock /tmp/mpgan.sock warmShape 64,64,64

Wire protocol (all integers little-endian u32):

    request:   b"MPSR" | version=1 | z y x c | f32 payload (z*y*x*c)
               b"MPQT"                                  -> orderly shutdown
    response:  b"MPOK" | z y x c | f32 payload          (success)
               b"MPER" | length  | utf-8 message        (failure)

One request per connection round-trip; a connection may issue many
sequentially. Concurrent connections are accepted; device dispatch is
serialized (on one card the model is one device program per request
shape, a replayed CUDA graph — overlap comes from the request threads
doing socket I/O while another request computes).

Serving-specific flags of :func:`main` (the model flags are those of
:func:`mpgan_torch.config.from_cli`):

    weights1/2/3  .npz weight files of passes 1-3 (weights1 is required)
    sock          Unix-socket path to listen on (default mpgan.sock)
    warmShape     "z,y,x" LR shape to run once before accepting requests
    device        "cuda" (default) or "cpu"
"""

from __future__ import annotations

import os
import socket
import struct
import threading

import numpy as np
import torch

MAGIC_REQ = b"MPSR"
MAGIC_QUIT = b"MPQT"
MAGIC_OK = b"MPOK"
MAGIC_ERR = b"MPER"
VERSION = 1
# guards against garbage headers allocating absurd buffers: 1024³ single-
# channel f32 (4 GiB) is the largest volume a request may describe
MAX_VOXELS = 1024 ** 3


def _recv_exact(conn: socket.socket, n: int) -> bytearray:
    """``n`` bytes from ``conn``, as a writable buffer: a request's payload
    becomes its array with no copy (``np.frombuffer``)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError(f"peer closed after {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return buf


def _to_host(x) -> np.ndarray:
    """A result volume as a contiguous float32 host array (waits for the
    device when ``x`` is a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _send_err(conn: socket.socket, msg: str) -> None:
    data = msg.encode()
    conn.sendall(MAGIC_ERR + struct.pack("<I", len(data)) + data)


class InferenceServer:
    """Serve ``upscale(lr_volume) -> hr_volume`` requests on a Unix socket.

    ``upscale`` takes a float32 ``(z, y, x, c)`` array and returns the
    super-resolved ``(Z, Y, X, 1)`` density as an array or a tensor on any
    device (e.g. :func:`make_upscaler`). ``expect_channels`` rejects
    requests whose channel count cannot feed the loaded model (a mismatch
    would retrace and then fail inside the conv stack with a shape error
    that means nothing to the client).
    """

    def __init__(self, upscale, sock_path: str, expect_channels: int = 0):
        self._upscale = upscale
        self._expect_c = expect_channels
        self._path = sock_path
        self._device_lock = threading.Lock()
        self._shutdown = threading.Event()
        if os.path.exists(sock_path):
            # only remove a STALE socket: silently unlinking a live server's
            # socket would leave it running (and holding the device) but
            # unreachable, with no error anywhere
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(1.0)
            try:
                probe.connect(sock_path)
                live = True
            except (ConnectionRefusedError, FileNotFoundError):
                live = False  # stale socket from a dead server
            except socket.timeout:
                # a connect TIMEOUT on a unix socket means a LIVE server
                # with a full accept backlog — unlinking it would strand
                # the running server exactly as this guard tries to prevent
                live = True
            finally:
                probe.close()
            if live:
                raise RuntimeError(
                    f"a live server is already bound to {sock_path}; "
                    "pick another 'sock' path or shut the old one down")
            os.remove(sock_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(sock_path)
        self._sock.listen(16)
        self._sock.settimeout(0.5)  # poll the shutdown flag in accept()

    def warm(self, shape: tuple[int, int, int, int]) -> None:
        """Run the upscaler twice for one LR shape up front: a graphed
        upscaler's first use is eager and its second captures, so the
        first request of that shape replays."""
        lr = np.zeros(shape, np.float32)
        for _ in range(2):
            _to_host(self._upscale(lr))

    def serve_forever(self) -> None:
        threads = []
        try:
            while not self._shutdown.is_set():
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                t = threading.Thread(target=self._handle, args=(conn,),
                                     daemon=True)
                t.start()
                threads.append(t)
                threads = [t for t in threads if t.is_alive()]
        finally:
            # let in-flight requests finish and answer: clipping the join
            # here would kill a long request with neither MPOK nor MPER on
            # the wire
            for t in threads:
                t.join(timeout=900)
            self._sock.close()
            if os.path.exists(self._path):
                os.remove(self._path)

    def _recv_magic(self, conn: socket.socket) -> bytes | None:
        """Read the next 4-byte magic, polling the shutdown flag.

        Between requests a keep-alive connection parks here; a plain 600 s
        recv would make shutdown block on every idle viewer. Short timeouts
        + re-check let idle handlers exit within ~1 s of shutdown while
        partial reads are preserved. Returns None on shutdown/peer close.
        """
        buf = bytearray()
        conn.settimeout(1.0)
        try:
            while not self._shutdown.is_set():
                try:
                    chunk = conn.recv(4 - len(buf))
                except socket.timeout:
                    continue
                if not chunk:
                    return None
                buf.extend(chunk)
                if len(buf) == 4:
                    return bytes(buf)
            return None
        finally:
            conn.settimeout(600)

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(600)
            while not self._shutdown.is_set():
                try:
                    magic = self._recv_magic(conn)
                except (ConnectionError, OSError):
                    return
                if magic is None:
                    return
                if magic == MAGIC_QUIT:
                    conn.sendall(MAGIC_OK + struct.pack("<4I", 0, 0, 0, 0))
                    self._shutdown.set()
                    return
                if magic != MAGIC_REQ:
                    _send_err(conn, f"bad magic {magic!r}")
                    return
                try:
                    if not self._one_request(conn):
                        return
                except (ConnectionError, socket.timeout):
                    return
                except Exception as e:  # report, keep serving others
                    try:
                        _send_err(conn, f"{type(e).__name__}: {e}")
                    except OSError:
                        pass
                    return

    def _one_request(self, conn: socket.socket) -> bool:
        """Serve one request; False = the connection must be closed."""
        ver, z, y, x, c = struct.unpack("<5I", _recv_exact(conn, 20))
        n = z * y * x * c
        if not 0 < n <= MAX_VOXELS:
            # cannot resync without reading an unbounded payload
            _send_err(conn, f"volume {z}x{y}x{x}x{c} out of range")
            return False
        # always drain the payload BEFORE any validation error: the client
        # sent header+payload in one write, and a connection may issue many
        # sequential requests — erroring with the payload unread would make
        # the next header read see payload bytes as a bogus magic
        payload = _recv_exact(conn, 4 * n)
        if ver != VERSION:
            _send_err(conn, f"protocol version {ver} != {VERSION}")
            return True
        if self._expect_c and c != self._expect_c:
            _send_err(conn, f"expected {self._expect_c} channels "
                            f"(model conditioning), got {c}")
            return True
        lr = np.frombuffer(payload, "<f4").reshape(z, y, x, c)
        with self._device_lock:  # one device program at a time
            hr_dev = self._upscale(lr)
        # device→host fetch OUTSIDE the lock, so it overlaps the next
        # request's dispatch: safe because the upscaler returns a tensor of
        # this request's own (a graphed upscaler copies its replay's output
        # out on the device), which the next request's replay cannot touch
        hr = _to_host(hr_dev)
        # two sends, zero copies: hdr + hr.tobytes() would allocate the
        # whole volume twice more (~1 GB transient at 512^3)
        conn.sendall(MAGIC_OK + struct.pack("<4I", *hr.shape))
        conn.sendall(memoryview(hr).cast("B"))
        return True


class Client:
    """Minimal blocking client for :class:`InferenceServer`.

    >>> with Client("/tmp/mpgan.sock") as c:
    ...     hr = c.upscale(lr)        # (z,y,x,c) f32 -> (Z,Y,X,1) f32
    """

    def __init__(self, sock_path: str, timeout: float = 1200.0):
        # a generous default: the first request of a new shape may be slow
        # when the server was started without warmShape
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(sock_path)

    def upscale(self, vol: np.ndarray) -> np.ndarray:
        vol = np.ascontiguousarray(vol, dtype=np.float32)
        if vol.ndim == 3:
            vol = vol[..., None]
        if vol.ndim != 4:
            raise ValueError(f"need (z,y,x,c), got shape {vol.shape}")
        self._sock.sendall(MAGIC_REQ + struct.pack("<5I", VERSION, *vol.shape))
        self._sock.sendall(memoryview(vol).cast("B"))  # zero-copy payload
        return self._read_response()

    def shutdown_server(self) -> None:
        self._sock.sendall(MAGIC_QUIT)
        _recv_exact(self._sock, 4 + 16)  # MPOK + zero dims

    def _read_response(self) -> np.ndarray:
        magic = _recv_exact(self._sock, 4)
        if magic == MAGIC_ERR:
            (ln,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            raise RuntimeError("server: " +
                               _recv_exact(self._sock, ln).decode())
        if magic != MAGIC_OK:
            raise RuntimeError(f"bad response magic {magic!r}")
        z, y, x, c = struct.unpack("<4I", _recv_exact(self._sock, 16))
        data = _recv_exact(self._sock, 4 * z * y * x * c)
        return np.frombuffer(data, "<f4").reshape(z, y, x, c).copy()

    def close(self) -> None:
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_upscaler(chain, device=None, up_res: int = 4, chunk: int = 0):
    """``lr (z, y, x, c) float32 array → HR tensor on the device`` over a
    loaded ``(gen1, gen2, gen3)`` chain (gen2/gen3 may be None).

    Runs under ``torch.inference_mode`` in the generators' own dtype (bf16
    or f32 per ``cfg.model.dtype``) and returns the result on the device
    without waiting for it; the server fetches it outside its lock. On one
    card it is :func:`mpgan_torch.infer.assemble.make_graphed_upscaler`:
    one captured program per request shape, eager at a shape's first
    request and replayed from its second on, each result a fresh tensor
    (JAX ``mpgan_tpu/infer/load.py:133-144`` jits the upscaler). With
    several cards every visible card takes a share of each pass's slices,
    each card's share a captured program of its own
    (``CUDA_VISIBLE_DEVICES`` limits them); on the CPU it runs eagerly."""
    from mpgan_torch.device import resolve_device
    from mpgan_torch.infer import assemble
    from mpgan_torch.parallel import mesh as pmesh
    from mpgan_torch.train import graphed

    dev = resolve_device(device)
    gen1, gen2, gen3 = chain
    devices = (pmesh.make_mesh() if dev.type == "cuda"
               and torch.cuda.device_count() > 1 else None)
    if graphed.graphable(dev, devices):
        up = assemble.make_graphed_upscaler(
            gen1, gen2, up_res, chunk=chunk, gen3=gen3, devices=devices)
        return lambda lr: up(np.asarray(lr, dtype=np.float32))

    def upscale(lr: np.ndarray) -> torch.Tensor:
        lr_t = torch.tensor(np.asarray(lr, dtype=np.float32), device=dev)
        with torch.inference_mode():
            return assemble.upscale_volume(gen1, gen2, lr_t, up_res,
                                           chunk=chunk, gen3=gen3)

    return upscale


def main(argv=None) -> None:
    """Serve a pass chain loaded from ``.npz`` weights (flags in the module
    docstring)."""
    from mpgan_torch import config as cfgmod
    from mpgan_torch.infer.load import input_channels, load_generator_npz
    from mpgan_torch.utils import params as ph

    if argv is not None:
        ph.setParams(argv)
    weights = [ph.getParam(f"weights{i}", "") for i in (1, 2, 3)]
    sock_path = ph.getParam("sock", "mpgan.sock")
    warm_shape = ph.getParam("warmShape", "")
    device = ph.getParam("device", "cuda")
    cfg = cfgmod.from_cli(None)
    if not weights[0]:
        raise SystemExit("weights1 <pass-1 .npz> is required")

    chain = tuple(load_generator_npz(w, i + 1, cfg, device) if w else None
                  for i, w in enumerate(weights))
    upscale = make_upscaler(chain, device, cfg.data.up_res,
                            cfg.infer.slice_chunk)
    c_in = input_channels(cfg, 1)
    server = InferenceServer(upscale, sock_path, expect_channels=c_in)
    if warm_shape:
        z, y, x = (int(v) for v in warm_shape.split(","))
        print(f"warming {z}x{y}x{x}x{c_in} ...", flush=True)
        server.warm((z, y, x, c_in))
    passes = sum(g is not None for g in chain)
    print(f"serving {passes}-pass {cfg.data.up_res}x SR on {sock_path} "
          f"({device})", flush=True)
    server.serve_forever()
    print("server shut down")


if __name__ == "__main__":
    main()
