"""The port's image decoders against ``cv2.imdecode`` (a test oracle only).

Every case is held bit-equal to ``cv2.imdecode(buf, IMREAD_COLOR)[..., ::-1]``:
PPM/PGM at 8 and 16 bits, PNG in every colour type and bit depth the
decoder reads (written by cv2, by Pillow, and by the port's own encoder
with each of the five row filters and with libpng's choice of filter per
row). Images above ``MAX_PIXELS`` are refused from their headers, and a PNG
inflates no more than its header describes. The C row unfilter is held
against the numpy one in tests/test_torch_cuda.py (it is built by nvcc).
"""

import io
import struct
import tracemalloc
import zlib

import numpy as np
import pytest
import torch

from objectdetection_torch.data import image_io

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")


def cv2_rgb(buf: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return bgr[:, :, ::-1]


def assert_decodes_as_cv2(buf: bytes):
    got = image_io.decode_image(buf)
    want = cv2_rgb(buf)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


RNG = np.random.RandomState(0)
IMAGES = {
    "rgb8": RNG.randint(0, 256, (37, 53, 3)).astype(np.uint8),
    "rgb16": RNG.randint(0, 65536, (21, 18, 3)).astype(np.uint16),
    "gray8": RNG.randint(0, 256, (19, 31)).astype(np.uint8),
    "gray16": RNG.randint(0, 65536, (9, 40)).astype(np.uint16),
    "bgra8": RNG.randint(0, 256, (16, 23, 4)).astype(np.uint8),
    "bgra16": RNG.randint(0, 65536, (11, 7, 4)).astype(np.uint16),
}


@pytest.mark.parametrize("name,ext", [(n, ".png") for n in sorted(IMAGES)] + [
    (n, ".ppm") for n in sorted(IMAGES) if not n.startswith("bgra")])  # PPM holds no alpha
def test_cv2_encoded_images_decode_bit_equal(name, ext):
    img = IMAGES[name]
    ok, buf = cv2.imencode(ext if img.ndim == 3 else (".pgm" if ext == ".ppm" else ext), img)
    assert ok
    assert_decodes_as_cv2(buf.tobytes())


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "1", "P", "P4", "I;16"])
def test_pillow_encoded_pngs_decode_bit_equal(mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(len(mode))
    if mode in ("L", "1"):
        im = Image.fromarray(rng.randint(0, 256, (13, 29)).astype(np.uint8), "L")
        im = im.convert("1") if mode == "1" else im
    elif mode == "I;16":
        im = Image.fromarray(rng.randint(0, 65536, (13, 29)).astype(np.uint16))
    elif mode in ("P", "P4"):
        colors = 256 if mode == "P" else 16
        im = Image.fromarray(rng.randint(0, colors, (17, 9)).astype(np.uint8), "P")
        im.putpalette(list(rng.randint(0, 256, 3 * colors)))
    else:
        c = {"LA": 2, "RGB": 3, "RGBA": 4}[mode]
        im = Image.fromarray(rng.randint(0, 256, (13, 29, c)).astype(np.uint8), mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", bits=4) if mode == "P4" else im.save(buf, "PNG")
    assert_decodes_as_cv2(buf.getvalue())


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), None])
@pytest.mark.parametrize("gray", [False, True])
def test_own_encoder_every_filter_roundtrips(filters, gray):
    img = IMAGES["gray8"] if gray else IMAGES["rgb8"]
    buf = image_io.encode_png(img, filters)
    got = assert_decodes_as_cv2(buf)
    np.testing.assert_array_equal(got, np.repeat(img[..., None], 3, -1) if gray else img)


def test_default_filters_are_chosen_per_row_as_libpng_does():
    # Pillow chooses as libpng does, leaving Average out; on this smooth
    # image no row's best filter is Average, so the two agree row for row
    Image = pytest.importorskip("PIL.Image")
    yy, xx = np.mgrid[0:97, 0:131].astype(np.float32)
    img = np.clip(np.stack([yy * 2, xx * 1.5, 100 + 50 * np.sin(yy / 9) * np.cos(xx / 11)], -1),
                  0, 255).astype(np.uint8)
    pil = io.BytesIO()
    Image.fromarray(img).save(pil, "PNG")
    ours = image_io.encode_png(img)
    kinds = image_io.png_row_filters(ours)
    np.testing.assert_array_equal(kinds, image_io.png_row_filters(pil.getvalue()))
    assert (kinds == 4).sum() > 90  # Paeth, the decoder's sequential case
    np.testing.assert_array_equal(assert_decodes_as_cv2(ours), img)


def png_bytes(w, h, data):
    return (image_io.PNG_SIGNATURE
            + image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + image_io._chunk(b"IDAT", data) + image_io._chunk(b"IEND", b""))


def test_png_inflates_only_what_its_header_describes():
    # a 4x4 header over 64 MB of zeros: decoded as cv2 decodes it (the data
    # past the image ignored) without inflating the zeros
    img = IMAGES["rgb8"][:4, :4]
    z = zlib.compressobj(9)
    zeros = bytes(1 << 20)
    data = z.compress(np.concatenate([np.zeros((4, 1), np.uint8), img.reshape(4, 12)], 1)
                      .tobytes()) + b"".join(z.compress(zeros) for _ in range(64)) + z.flush()
    buf = png_bytes(4, 4, data)
    tracemalloc.start()
    try:
        got = image_io.decode_image(buf)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < (1 << 20), peak
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(cv2_rgb(buf), img)


@pytest.mark.parametrize("fmt", ["png", "ppm", "jpeg"])
def test_images_above_the_pixel_limit_are_refused_from_the_header(fmt):
    if fmt == "png":  # 2^20 x 2^20 declared over a few bytes of data
        buf = png_bytes(1 << 20, 1 << 20, zlib.compress(bytes(64)))
    elif fmt == "ppm":
        buf = b"P6\n9000 8000\n255\n" + bytes(64)
    else:  # a small JPEG whose frame header declares 9000 x 8000 (Pillow's path)
        pytest.importorskip("PIL.Image")
        ok, enc = cv2.imencode(".jpg", IMAGES["rgb8"])
        buf = bytearray(enc.tobytes())
        sof = buf.index(b"\xff\xc0")
        buf[sof + 5:sof + 9] = struct.pack(">HH", 8000, 9000)
        buf = bytes(buf)
    assert 9000 * 8000 > image_io.MAX_PIXELS
    with pytest.raises(image_io.ImageDecodeError, match="above the limit"):
        image_io.decode_image(buf)


def test_ppm_roundtrip_and_comments():
    img = IMAGES["rgb8"]
    got = assert_decodes_as_cv2(image_io.encode_ppm(img))
    np.testing.assert_array_equal(got, img)
    buf = b"P6\n# a comment\n2 1\n# another\n100\n" + bytes([0, 50, 100, 10, 20, 30])
    np.testing.assert_array_equal(assert_decodes_as_cv2(buf), [[[0, 50, 100], [10, 20, 30]]])


@pytest.mark.parametrize("buf", [b"", b"not an image", b"P6\n2 1\n255\n\x01\x02",
                                 image_io.PNG_SIGNATURE + b"\x00\x00"])
def test_bad_bytes_raise(buf):
    with pytest.raises(image_io.ImageDecodeError):
        image_io.decode_image(buf)


def test_png_crc_is_checked():
    buf = bytearray(image_io.encode_png(IMAGES["rgb8"]))
    buf[40] ^= 0xFF  # inside the IDAT data
    with pytest.raises(image_io.ImageDecodeError, match="CRC|inflate"):
        image_io.decode_png(bytes(buf))


def test_jpeg_goes_through_pillow_when_it_imports():
    pytest.importorskip("PIL.Image")
    ok, buf = cv2.imencode(".jpg", IMAGES["rgb8"])
    got = image_io.decode_image(buf.tobytes())
    assert got.shape == (37, 53, 3) and got.dtype == np.uint8
    # another JPEG decoder: close to cv2's, not bit-equal
    assert np.abs(got.astype(int) - cv2_rgb(buf.tobytes()).astype(int)).mean() < 2.0


# ---------------------------------------------------------------- EXIF orientation
#
# cv2's IMREAD_COLOR turns the pixels upright by the EXIF Orientation tag
# (0x0112) of a JPEG's APP1 segment or a PNG's eXIf chunk; decode_image must
# return what cv2 returns, in shape and pixels, for every tag.

ORIENTED = RNG.randint(0, 256, (40, 64, 3)).astype(np.uint8)  # not square


def tiff_block(orientation: int, order: str = "II", entries=None) -> bytes:
    """An EXIF TIFF block whose IFD0 holds ``entries`` (tag, type, count,
    16-bit value), by default the Orientation tag alone as a SHORT."""
    e = "<" if order == "II" else ">"
    entries = entries or [(0x0112, 3, 1, orientation)]
    ifd = struct.pack(e + "H", len(entries)) + b"".join(
        struct.pack(e + "HHIHH", tag, kind, count, value, 0)
        for tag, kind, count, value in entries)
    return order.encode() + struct.pack(e + "HI", 42, 8) + ifd + struct.pack(e + "I", 0)


def with_exif(fmt: str, block: bytes, header: bytes = b"Exif\0\0") -> bytes:
    """ORIENTED as PNG (the port's encoder, an eXIf chunk before IDAT) or as
    JPEG (cv2's encoder, an APP1 segment after its JFIF APP0)."""
    if fmt == "png":
        buf = image_io.encode_png(ORIENTED)
        at = buf.index(b"IDAT") - 4
        return buf[:at] + image_io._chunk(b"eXIf", block) + buf[at:]
    buf = cv2.imencode(".jpg", ORIENTED[..., ::-1].copy())[1].tobytes()
    at = 4 + struct.unpack(">H", buf[4:6])[0]  # past SOI and APP0
    payload = header + block
    return buf[:at] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + buf[at:]


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_the_image_as_cv2_does(orientation, fmt, order):
    if fmt == "jpeg":
        pytest.importorskip("PIL.Image")
    got = assert_decodes_as_cv2(with_exif(fmt, tiff_block(orientation, order)))
    assert got.shape == ((64, 40, 3) if orientation >= 5 else (40, 64, 3))


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_written_by_pillow_turns_the_image_as_cv2_does(orientation, fmt):
    Image = pytest.importorskip("PIL.Image")
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(ORIENTED).save(buf, fmt.upper(), exif=exif.tobytes())
    assert image_io.exif_orientation(buf.getvalue()) == orientation
    assert_decodes_as_cv2(buf.getvalue())


MALFORMED = {
    "zero": tiff_block(0),
    "nine": tiff_block(9),
    "byte order": b"XX" + tiff_block(6)[2:],
    "mark": tiff_block(6)[:2] + b"\x2b\x00" + tiff_block(6)[4:],
    "ifd past the end": tiff_block(6)[:4] + struct.pack("<I", 1000) + tiff_block(6)[8:],
    "entry cut short": tiff_block(6)[:16],
    "no orientation": tiff_block(0, entries=[(0x010F, 2, 1, 0)]),
}


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_a_missing_or_malformed_orientation_reads_as_1(case, fmt):
    if fmt == "jpeg":
        pytest.importorskip("PIL.Image")
    buf = with_exif(fmt, MALFORMED[case])
    assert image_io.exif_orientation(buf) == 1
    got = assert_decodes_as_cv2(buf)
    assert got.shape == ORIENTED.shape


def test_orientation_is_read_from_whole_entries_in_order():
    # the tag after another entry, and an IFD that counts more entries than
    # its block holds: cv2 reads the entries that fit
    second = tiff_block(0, entries=[(0x010F, 2, 1, 0), (0x0112, 3, 1, 6)])
    short_count = bytearray(tiff_block(6))
    short_count[8] = 5
    for block in (second, bytes(short_count)):
        assert image_io.tiff_orientation(block) == 6
        assert assert_decodes_as_cv2(with_exif("png", block)).shape == (64, 40, 3)
    # an APP1 that is not "Exif\0\0" carries no orientation
    pytest.importorskip("PIL.Image")
    buf = with_exif("jpeg", tiff_block(6), header=b"Exif\0\xff")
    assert assert_decodes_as_cv2(buf).shape == ORIENTED.shape


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_turns_without_pillow(orientation, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)  # `import PIL` raises ImportError
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    for order in ("II", "MM"):
        assert_decodes_as_cv2(with_exif("png", tiff_block(orientation, order)))
