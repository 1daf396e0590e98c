"""The port's PNG module (mygauhuman_torch/utils/image_io.py) against
imageio, which the JAX package uses for its PNGs: pixel arrays equal both
ways (exact: both are lossless 8-bit), for gray, gray + alpha, RGB and
RGBA, and every row filter of the PNG format decoded (files written here
with each of the five filters, and imageio's own adaptively filtered
files)."""
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from mygauhuman_torch.utils.image_io import read_png, write_png

SHAPES = {"gray": (13, 17), "gray_alpha": (13, 17, 2), "rgb": (13, 17, 3), "rgba": (13, 17, 4)}


def _image(shape, smooth):
    rng = np.random.RandomState(len(shape) * 7 + shape[-1])
    if not smooth:
        return rng.randint(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = (yy * 9 + xx * 5) % 256
    if len(shape) == 2:
        return base.astype(np.uint8)
    return np.stack([(base + 31 * c) % 256 for c in range(shape[2])], -1).astype(np.uint8)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_port_png_reads_in_imageio(tmp_path, kind, smooth):
    img = _image(SHAPES[kind], smooth)
    path = str(tmp_path / "port.png")
    write_png(path, img)
    back = imageio.imread(path)
    np.testing.assert_array_equal(np.asarray(back), img)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_imageio_png_reads_in_port(tmp_path, kind, smooth):
    """imageio (Pillow) picks a filter per row adaptively, so smooth images
    carry Sub / Up / Average / Paeth rows."""
    img = _image(SHAPES[kind], smooth)
    path = str(tmp_path / "imageio.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(path, img, filters):
    """An RGB PNG whose row y is written with filter filters[y] (PNG
    specification, section 9), one IDAT chunk."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f, cur = filters[y], rows[y]
        prev = rows[y - 1] if y > 0 else np.zeros_like(cur)
        line = []
        for i in range(w * c):
            a = cur[i - c] if i >= c else 0
            b, cc = prev[i], (prev[i - c] if i >= c else 0)
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[f]
            line.append((cur[i] - pred) % 256)
        out += bytes([f]) + bytes(line)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_every_row_filter_decodes(tmp_path, filt):
    img = _image((10, 9, 3), smooth=False)
    filters = [y % 5 for y in range(10)] if filt == "mixed" else [filt] * 10
    path = str(tmp_path / f"f{filt}.png")
    _filtered_png(path, img, filters)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, np.zeros((4, 4), np.uint16) + 300)
    with pytest.raises(ValueError, match="8-bit"):
        read_png(path)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, np.zeros((4, 4), np.float32))
