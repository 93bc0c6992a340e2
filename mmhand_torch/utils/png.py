"""A small PNG codec for 8-bit RGB images, on the standard library and
numpy alone; each ``write_png`` is the span ``png.encode`` of
``utils.trace``.

The rows are deflated at zlib level 6, unfiltered.  In a process with
more than one usable core, an image of more than ``_STRIPE`` raw bytes is
cut into stripes of that many bytes, rounded up to whole rows (12 for a
256 x 256 fake).  Each stripe is a raw deflate stream ended by a sync
flush, the last by the stream's end, and the stripes are joined behind one
zlib header and before the Adler-32 of the whole buffer, so the file holds
one ordinary zlib stream.  The caller and a pool thread per further usable
core deflate them (zlib lets go of the GIL while it compresses), each
taking the next stripe as soon as it is free: the encode uses the cores
that are free at the time and waits on no busy one.  A stripe starts with
an empty window, which makes a fake ~0.1-0.2% larger than one stream does.
An image of one stripe gives the bytes of one ``zlib.compress`` call.
Every encode adds its stripe count to the counter ``png.stripes``, and a
striped one adds 1 to ``png.striped_writes``.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from mmhand_torch.utils import trace

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_LEVEL = 6
# raw bytes a stripe holds, rounded up to whole rows: a thread's hand-off
# is then well under a tenth of its deflate
_STRIPE = 1 << 14
# zlib's header for a 32 KiB window at the default level
_ZLIB_HEADER = b"\x78\x9c"

# the stripes' threads: (pid, pool)
_pool = None
_pool_lock = threading.Lock()


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _executor() -> ThreadPoolExecutor:
    """The process's stripe pool, made on its first striped encode (anew
    in a forked child): one thread per usable core but the caller's."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid():
            workers = max(1, len(os.sched_getaffinity(0)) - 1)
            _pool = (os.getpid(),
                     ThreadPoolExecutor(workers, thread_name_prefix="png"))
        return _pool[1]


def _deflate_stripe(buf: memoryview, last: bool) -> bytes:
    c = zlib.compressobj(_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
    return c.compress(buf) + c.flush(zlib.Z_FINISH if last
                                     else zlib.Z_SYNC_FLUSH)


def _deflate_some(stripes: list, out: list, todo) -> None:
    """Deflate into ``out`` the stripes whose indices ``todo`` yields; the
    encoders of one image share ``todo``."""
    last = len(stripes) - 1
    for i in todo:
        out[i] = _deflate_stripe(stripes[i], i == last)


def _deflate(rows: np.ndarray) -> bytes:
    """The zlib stream of the (H, 1 + 3W) row buffer, striped where the
    image and the usable cores allow."""
    h, width = rows.shape
    cores = len(os.sched_getaffinity(0))
    per = (-(-_STRIPE // width) if cores > 1 else max(h, 1)) * width
    n = max(1, -(-rows.size // per))
    buf = memoryview(rows.reshape(-1))
    stripes = [buf[i * per:(i + 1) * per] for i in range(n)]
    trace.count("png.stripes", n)
    out, todo, pending = [b""] * n, iter(range(n)), []
    if n > 1:
        trace.count("png.striped_writes")
        pool = _executor()
        pending = [pool.submit(_deflate_some, stripes, out, todo)
                   for _ in range(min(cores, n) - 1)]
    _deflate_some(stripes, out, todo)
    # a task no thread has started would find no stripe left
    for f in pending:
        if not f.cancel():
            f.result()
    return b"".join([_ZLIB_HEADER, *out,
                     struct.pack(">I", zlib.adler32(buf))])


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (no row filter, zlib level 6)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", _deflate(rows))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode and write ``img``; returns once the whole file is written."""
    with trace.span("png.encode"), open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as ``encode_png`` writes it (8-bit RGB, no row filter)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, idat, shape = len(_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, color, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: only 8-bit RGB is read")
            shape = (h, w)
        elif kind == b"IDAT":
            idat.append(body)
    h, w = shape
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not read")
    return rows[:, 1:].reshape(h, w, 3).copy()
