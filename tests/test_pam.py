import os

import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.utils import pam
from tests.conftest import REFERENCE_DIR, reference_available


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(16, 8, 4), dtype=np.uint8)
    img = pam.ImgInfo(width=8, height=16, channels=4, data=data)
    f = str(tmp_path / "x.ppm")
    pam.save_pam(f, img)
    back = pam.load_pam(f)
    assert (back.width, back.height, back.channels) == (8, 16, 4)
    np.testing.assert_array_equal(back.data, data)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_reads_reference_golden():
    golden = os.path.join(REFERENCE_DIR, "CLSuperPathTracer", "result.ppm")
    img = pam.load_pam(golden)
    assert (img.width, img.height, img.channels) == (512, 512, 4)
    assert img.maxval == 255
    assert np.asarray(img.data)[..., 3].min() == 255  # alpha saturated


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_writer_is_byte_compatible(tmp_path):
    """save_pam(load_pam(golden)) must reproduce the golden byte-for-byte."""
    golden = os.path.join(REFERENCE_DIR, "CLSuperPathTracer", "result.ppm")
    img = pam.load_pam(golden)
    f = str(tmp_path / "copy.ppm")
    pam.save_pam(f, img)
    with open(golden, "rb") as a, open(f, "rb") as b:
        assert a.read() == b.read()


def test_roundtrip_16bit(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 65536, size=(6, 4, 4), dtype=np.uint16)
    img = pam.ImgInfo(width=4, height=6, channels=4, maxval=65535, depth=16,
                      data=data)
    f = str(tmp_path / "x16.ppm")
    pam.save_pam(f, img)
    back = pam.load_pam(f)
    assert back.depth == 16 and back.maxval == 65535
    np.testing.assert_array_equal(back.data, data)


def test_film_to_rgba8_saturate_and_wrap():
    film = np.array([[[-20.0, 100.4, 300.0]]], np.float32)
    sat = pam.film_to_rgba8(film, ambient=(0, 0, 0))
    np.testing.assert_array_equal(sat[0, 0], [0, 100, 255, 255])
    wrap = pam.film_to_rgba8(film, ambient=(0, 0, 0), wrap=True)
    assert wrap[0, 0, 1] == 100
    assert wrap[0, 0, 2] == 300 % 256
    assert wrap[0, 0, 3] == 255


def test_device_quantization_matches_host():
    """The CLI quantises on device when the film is device-resident
    (ops/reduce.py::quantize_film / quantize_film16) so only RGBA8/16
    crosses to the host; it must be BIT-identical to the host
    film_to_rgba8/16 path on every value class: fractional, negative
    (bidirectional's shadow correction can undershoot), and >255
    (the wrap quirk's whole reason to exist)."""
    import jax
    from opencl_montecarlo_path_tracing_tpu.ops.reduce import (
        quantize_film, quantize_film16)

    rng = np.random.default_rng(7)
    film = rng.uniform(-40.0, 600.0, size=(9, 11, 3)).astype(np.float32)
    # exact integer boundaries too (trunc/round ties)
    film[0, :, :] = np.array([254.0, 255.0, 256.0], np.float32)
    film[1, :, :] = np.array([-13.0, -0.5, 242.5], np.float32)

    dev = np.asarray(jax.jit(quantize_film, static_argnames="wrap")(
        film, wrap=False))
    np.testing.assert_array_equal(dev, pam.film_to_rgba8(film, wrap=False))

    dev = np.asarray(jax.jit(quantize_film, static_argnames="wrap")(
        film, wrap=True))
    np.testing.assert_array_equal(dev, pam.film_to_rgba8(film, wrap=True))

    dev16 = np.asarray(jax.jit(quantize_film16)(film))
    np.testing.assert_array_equal(dev16, pam.film_to_rgba16(film))


def test_save_png_round_trips(tmp_path):
    """The zlib PNG preview writer: signature, IHDR, and IDAT rows that
    decompress back to the RGBA pixels (filter byte 0 per row)."""
    import struct
    import zlib
    from opencl_montecarlo_path_tracing_tpu.utils.pam import save_png
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    path = tmp_path / "x.png"
    save_png(str(path), rgba)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    assert struct.unpack(">IIBBBBB", chunks[b"IHDR"]) == (7, 5, 8, 6, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(5, 1 + 7 * 4)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(5, 7, 4), rgba)
    assert b"IEND" in chunks
