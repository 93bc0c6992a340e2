"""The port's PNG writer (``mmhand_torch.utils.png``): striped and
single-stream encodes read back exactly by the port's reader, the
benchmark's independent reader and PIL; the striped file's size against
one ``zlib.compress``; small images and one-core processes keep today's
exact bytes; an encode does not wait on busy pool threads; concurrent
writers share the stripe pool."""

import os
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from benchmark.traffic import png as bench_png
from mmhand_torch.utils import png, trace

SHAPES = [(5, 7), (1, 1), (255, 257), (256, 256), (512, 512)]
KINDS = ["noise", "smooth", "constant"]


def _image(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "smooth":
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                        (x + 2 * y) % 256], -1)
        return (img + rng.integers(-2, 3, img.shape)).clip(0, 255).astype(
            np.uint8)
    return np.full((h, w, 3), 77 + seed % 100, np.uint8)


def _rows(img):
    h, w, _ = img.shape
    return np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1).tobytes()


def _idat(data):
    """The joined IDAT payload of PNG bytes."""
    pos, out = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    return b"".join(out)


def _cores(monkeypatch, n):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)))


def _counted(fn):
    """``fn()`` and what it added to ``png.stripes``, ``png.striped_writes``."""
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, tuple(after.get(k, 0) - before.get(k, 0)
                      for k in ("png.stripes", "png.striped_writes"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_round_trip(h, w, kind, tmp_path, monkeypatch):
    _cores(monkeypatch, 8)
    img = _image(kind, h, w)
    path = str(tmp_path / "x.png")
    _, (stripes, striped) = _counted(lambda: png.write_png(path, img))
    with open(path, "rb") as f:
        data = f.read()
    assert zlib.decompress(_idat(data)) == _rows(img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(bench_png.read_png(path), img)
    with Image.open(path) as pil:
        assert pil.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(pil), img)
    width = 1 + 3 * w
    want = -(-h * width // (-(-png._STRIPE // width) * width))
    assert (stripes, striped) == (want, int(want > 1))
    if (h, w) == (256, 256):
        assert stripes == 12


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_striped_file_is_within_a_percent_of_one_stream(kind, monkeypatch):
    _cores(monkeypatch, 8)
    img = _image(kind, 256, 256, seed=3)
    data, (stripes, _) = _counted(lambda: png.encode_png(img))
    assert stripes == 12
    assert len(_idat(data)) <= 1.01 * len(zlib.compress(_rows(img), 6))


def test_constant_image_pays_a_few_bytes_a_stripe(monkeypatch):
    """A flat image deflates to ~700 bytes; each stripe adds its own block
    header, first literals and sync flush."""
    _cores(monkeypatch, 8)
    img = _image("constant", 256, 256)
    data, (stripes, _) = _counted(lambda: png.encode_png(img))
    extra = len(_idat(data)) - len(zlib.compress(_rows(img), 6))
    assert stripes == 12 and extra <= 32 * stripes


@pytest.mark.parametrize("cores,h,w", [(8, 5, 7), (8, 1, 1), (1, 512, 512),
                                       (1, 256, 256)])
def test_single_stream_keeps_todays_bytes(cores, h, w, monkeypatch):
    """Small images, and any image in a one-core process, encode to the
    bytes of one ``zlib.compress`` (the benchmark's own encoder)."""
    _cores(monkeypatch, cores)
    img = _image("noise", h, w, seed=h)
    data, counted = _counted(lambda: png.encode_png(img))
    assert counted == (1, 0)
    assert data == bench_png.encode_png(img)


def test_pool_is_made_on_the_first_striped_encode_and_anew_after_fork(
        monkeypatch):
    _cores(monkeypatch, 4)
    monkeypatch.setattr(png, "_pool", None)
    png.encode_png(_image("noise", 5, 7))
    assert png._pool is None
    img = _image("noise", 256, 256)
    png.encode_png(img)
    pid, first = png._pool
    assert pid == os.getpid() and first._max_workers == 3
    png.encode_png(img)
    assert png._pool[1] is first
    monkeypatch.setattr(os, "getpid", lambda: pid + 1)
    data = png.encode_png(img)
    assert png._pool[0] == pid + 1 and png._pool[1] is not first
    assert zlib.decompress(_idat(data)) == _rows(img)
    first.shutdown()
    png._pool[1].shutdown()


def test_busy_pool_leaves_the_stripes_to_the_caller(monkeypatch):
    """With every pool thread held elsewhere, an encode does not wait for
    them: the caller deflates all the stripes itself."""
    _cores(monkeypatch, 3)
    monkeypatch.setattr(png, "_pool", None)
    img = _image("smooth", 256, 256)
    png.encode_png(img)
    pool, gate, done = png._pool[1], threading.Event(), []
    held = [pool.submit(gate.wait, 60) for _ in range(pool._max_workers)]
    th = threading.Thread(
        target=lambda: done.append(_counted(lambda: png.encode_png(img))))
    try:
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    finally:
        gate.set()
        th.join()
        for f in held:
            f.result()
        pool.shutdown()
    data, (stripes, striped) = done[0]
    assert (stripes, striped) == (12, 1)
    assert zlib.decompress(_idat(data)) == _rows(img)


def test_two_writers_at_once(tmp_path, monkeypatch):
    """Two threads write 32 files each through one pool with more threads
    than the process's cores; every file reads back exactly."""
    _cores(monkeypatch, 2 * len(os.sched_getaffinity(0)) + 2)
    monkeypatch.setattr(png, "_pool", None)
    imgs = {(t, i): _image(KINDS[i % 3], 256, 256, seed=100 * t + i)
            for t in range(2) for i in range(32)}
    errors = []

    def writer(t):
        try:
            for i in range(32):
                png.write_png(str(tmp_path / f"{t}_{i}.png"), imgs[t, i])
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
        png._pool[1].shutdown()
    assert not any(th.is_alive() for th in threads) and not errors
    for (t, i), img in imgs.items():
        np.testing.assert_array_equal(
            png.read_png(str(tmp_path / f"{t}_{i}.png")), img)
