"""Image decoding and encoding with numpy and the standard library.

The server and the CLI read images through :func:`decode_image`, which
returns what ``cv2.imdecode(buf, IMREAD_COLOR)[..., ::-1]`` returns (RGB
uint8 [H, W, 3]) for the formats it decodes itself:

- binary PPM and PGM (``P6``, ``P5``), any maxval: 8-bit samples as stored,
  16-bit samples shifted right by 8;
- PNG, non-interlaced: gray, gray + alpha, RGB, RGBA and palette images,
  8- and 16-bit (and 1/2/4-bit gray and palette), all five row filters,
  CRCs checked. Gray is replicated, alpha dropped, 16-bit samples shifted
  right by 8 and sub-byte gray scaled to 0-255, as ``IMREAD_COLOR`` does.

Other formats (JPEG, interlaced PNG, ...) go through Pillow when it
imports; without it :func:`decode_image` raises :class:`ImageDecodeError`
with the reason.

The EXIF Orientation tag turns the pixels upright as ``IMREAD_COLOR``
turns them: it is read from a JPEG's APP1 ``Exif`` segment or a PNG's
``eXIf`` chunk (either TIFF byte order; missing, malformed or outside 1-8
reads as 1, as in cv2), and its flip or transpose is applied in numpy after
decoding, on the own PNG path and on Pillow's alike (Pillow's ``convert``
ignores the tag). A PNG therefore turns without Pillow.

An image of more than :data:`MAX_PIXELS` pixels is refused from its
header (W x H, which a turn does not change), before any data is inflated
or decoded, and a PNG inflates no further than the bytes its header
describes: a small body cannot make a large allocation.
:func:`encode_png` and :func:`encode_ppm` write RGB images.

PNG rows filtered with Average or Paeth (as libpng and Pillow write most
rows of a photo) form a recurrence along each row. :func:`unfilter` walks
it in numpy along anti-diagonals (~0.3-0.5 s for a 1200x900 photo);
``native=True`` undoes the filters in one C loop instead
(``csrc/png_unfilter.cu``, built by ``nvcc`` on first use; ~10-15 ms), which
is what the server and the CLI use when they run on the card.
"""

from __future__ import annotations

import functools
import io
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the most pixels an image may have: 67 M (8192 x 8192). The server molds
# every image in float32 (12 bytes a pixel), so one request stays near 1 GB
# of host memory; cv2.imdecode's own limit is 2^30 pixels
MAX_PIXELS = 1 << 26
# channels of each PNG colour type: gray, RGB, palette, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class ImageDecodeError(ValueError):
    """The bytes are no image that can be decoded here."""


class _Unsupported(ImageDecodeError):
    """A well-formed image in a format this module does not decode itself."""


def _check_size(w: int, h: int) -> None:
    if w * h > MAX_PIXELS:
        raise ImageDecodeError(f"image of {w}x{h} pixels is above the limit of "
                               f"{MAX_PIXELS} pixels")


def decode_image(buf: bytes, native: bool = False) -> np.ndarray:
    """Image file bytes → RGB uint8 [H, W, 3]; ``native`` as in
    :func:`decode_png`."""
    buf = bytes(buf)
    try:
        if buf.startswith(PNG_SIGNATURE):
            return decode_png(buf, native)
        if buf[:2] in (b"P5", b"P6"):
            return decode_pnm(buf)
        raise _Unsupported("not a PNG or binary PPM/PGM")
    except _Unsupported as own:
        try:
            from PIL import Image
        except ImportError:
            raise ImageDecodeError(f"{own}, and Pillow is not installed") from None
        try:
            with Image.open(io.BytesIO(buf)) as im:  # reads the header only
                _check_size(*im.size)
                rgb = np.array(im.convert("RGB"), np.uint8)  # a writable copy
        except ImageDecodeError:
            raise
        except Exception as exc:  # Pillow raises many types for bad bytes
            raise ImageDecodeError(f"{own}; Pillow: {exc}") from None
        return upright(rgb, exif_orientation(buf))


# EXIF orientation -> the view of the decoded [H, W, C] pixels that is
# upright: cv2's applyExifOrientation (2 flips left-right, 6 is a turn of
# 90 degrees clockwise, 5-8 transpose)
_UPRIGHT = {
    2: lambda a: a[:, ::-1],
    3: lambda a: a[::-1, ::-1],
    4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1),
    6: lambda a: a.swapaxes(0, 1)[:, ::-1],
    7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
    8: lambda a: a.swapaxes(0, 1)[::-1],
}


def upright(pixels: np.ndarray, orientation: int) -> np.ndarray:
    """``pixels`` [H, W, C] as EXIF ``orientation`` (1-8) says they are
    seen, contiguous (a new array unless ``orientation`` is 1)."""
    return np.ascontiguousarray(_UPRIGHT.get(orientation, lambda a: a)(pixels))


def tiff_orientation(block: bytes) -> int:
    """The Orientation tag (0x0112) of an EXIF TIFF block (a PNG ``eXIf``
    chunk, or a JPEG APP1 payload after ``Exif\\0\\0``): 1-8, or 1 where
    it is missing, malformed or out of range. Read as cv2 reads it: byte
    order ``II`` or ``MM``, the mark 42, then IFD0's entries in order while
    whole ones fit, the tag's first 16-bit value whatever its stated type."""
    if len(block) < 8 or block[:2] not in (b"II", b"MM"):
        return 1
    order = "<" if block[:2] == b"II" else ">"
    mark, ifd = struct.unpack_from(order + "HI", block, 2)
    if mark != 42 or ifd + 2 > len(block):
        return 1
    (count,) = struct.unpack_from(order + "H", block, ifd)
    for pos in range(ifd + 2, min(ifd + 2 + 12 * count, len(block) - 11), 12):
        tag, _, _, value = struct.unpack_from(order + "HHIH", block, pos)
        if tag == 0x0112:
            return value if 1 <= value <= 8 else 1
    return 1


def _jpeg_exif(buf: bytes) -> bytes:
    """The TIFF block of a JPEG's first APP1 ``Exif`` segment before its
    scan, or b"" where it has none."""
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if marker == 0xFF:  # a fill byte
            pos += 1
        elif marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:  # no length
            pos += 2
        elif marker in (0xD9, 0xDA):  # end of image, start of scan
            break
        else:
            (length,) = struct.unpack_from(">H", buf, pos + 2)
            segment = buf[pos + 4:pos + 2 + length]
            if marker == 0xE1 and segment.startswith(b"Exif\0\0"):
                return segment[6:]
            pos += 2 + length
    return b""


def exif_orientation(buf: bytes) -> int:
    """The EXIF orientation (1-8) of JPEG or PNG bytes; 1 for any other
    format, or where the tag is missing or malformed."""
    if buf.startswith(PNG_SIGNATURE):
        return tiff_orientation(next((d for k, d in _png_chunks(buf) if k == b"eXIf"), b""))
    if buf.startswith(b"\xff\xd8"):
        return tiff_orientation(_jpeg_exif(buf))
    return 1


def _to_rgb8(samples: np.ndarray, channels: int) -> np.ndarray:
    """[H, W, channels] uint8/uint16 samples → RGB uint8 (16-bit >> 8, gray
    replicated, alpha dropped)."""
    if samples.dtype != np.uint8:
        samples = (samples >> 8).astype(np.uint8)
    if channels in (1, 2):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def decode_pnm(buf: bytes) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) → RGB uint8."""
    tokens, pos = [], 2
    while len(tokens) < 3:
        while pos < len(buf) and buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            while pos < len(buf) and buf[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(buf) and buf[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ImageDecodeError("malformed PNM header")
        tokens.append(int(buf[start:pos]))
    if pos >= len(buf) or not buf[pos:pos + 1].isspace():
        raise ImageDecodeError("malformed PNM header")
    pos += 1  # one whitespace byte ends the header
    w, h, maxval = tokens
    channels = 3 if buf[:2] == b"P6" else 1
    if w <= 0 or h <= 0 or not 0 < maxval < 65536:
        raise ImageDecodeError(f"bad PNM size {w}x{h} or maxval {maxval}")
    _check_size(w, h)
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = w * h * channels * dtype.itemsize
    if len(buf) - pos < n:
        raise ImageDecodeError("PNM data ends early")
    samples = np.frombuffer(buf, dtype, w * h * channels, pos).reshape(h, w, channels)
    return _to_rgb8(samples.astype(np.uint16) if dtype.itemsize == 2 else samples, channels)


def _png_chunks(buf: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(buf):
            raise ImageDecodeError("PNG chunk ends early")
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) != crc:
            raise ImageDecodeError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ImageDecodeError("PNG has no IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG row filters: raw [H, rowbytes] uint8 with filter kinds [H] →
    the scanlines. Byte (r, i) depends on (r, i - bpp), (r - 1, i) and
    (r - 1, i - bpp), so every anti-diagonal of (row, pixel) is computed in
    one step."""
    h, rowbytes = raw.shape
    if np.any(kinds > 4):
        raise ImageDecodeError(f"bad PNG filter type {int(kinds.max())}")
    units = rowbytes // bpp
    raw3 = raw.reshape(h, units, bpp)
    if not np.any(kinds >= 3):  # None, Sub and Up: sums along rows and columns, mod 256
        out = np.empty((h, units, bpp), np.uint8)
        prior = np.zeros((units, bpp), np.uint8)
        for r in range(h):
            row = raw3[r]
            if kinds[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif kinds[r] == 2:
                row = row + prior
            prior = out[r] = row
        return out.reshape(h, rowbytes)
    raw3 = raw3.astype(np.int16)
    x = np.zeros((h + 1, units + 1, bpp), np.int16)  # a zero row above, a zero column left
    for d in range(h + units - 1):
        r = np.arange(max(0, d - units + 1), min(h, d + 1))
        i = d - r
        a, b, c = x[r + 1, i], x[r, i + 1], x[r, i]  # left, up, up-left
        k = kinds[r][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        x[r + 1, i + 1] = (raw3[r, i] + pred) & 255
    return x[1:, 1:].reshape(h, rowbytes).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _native_unfilter():
    import ctypes

    from objectdetection_torch.ops import cuda_build

    return cuda_build.Entry("png_unfilter", "png_unfilter", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p],
        result=ctypes.c_int64, stream=False).fn


def unfilter_native(rows: np.ndarray, bpp: int) -> np.ndarray:
    """:func:`unfilter` in one C loop (``csrc/png_unfilter.cu``, built by
    ``nvcc`` on first use): rows [H, 1 + rowbytes] uint8, each row's filter
    type first → the [H, rowbytes] scanlines."""
    rows = np.ascontiguousarray(rows, np.uint8)
    h, rowbytes = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, rowbytes), np.uint8)
    bad = _native_unfilter()(rows.ctypes.data, h, rowbytes, bpp, out.ctypes.data)
    if bad:
        raise ImageDecodeError(f"bad PNG filter type {int(rows[bad - 1, 0])}")
    return out


def decode_png(buf: bytes, native: bool = False) -> np.ndarray:
    """Non-interlaced PNG → RGB uint8, turned upright by its ``eXIf``
    orientation; ``native`` undoes the row filters with
    :func:`unfilter_native` instead of :func:`unfilter`."""
    header, palette, idat, exif = None, None, [], b""
    for kind, data in _png_chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"eXIf" and not exif:
            exif = data
    if header is None or not idat:
        raise ImageDecodeError("PNG has no IHDR or no IDAT")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _PNG_CHANNELS or compression or filt or w == 0 or h == 0:
        raise ImageDecodeError(f"bad PNG header {header}")
    if interlace:
        raise _Unsupported("interlaced PNG")
    if depth not in ((1, 2, 4, 8) if ctype == 3 else (8, 16) if ctype != 0 else (1, 2, 4, 8, 16)):
        raise ImageDecodeError(f"bad PNG bit depth {depth} for colour type {ctype}")
    if ctype == 3 and palette is None:
        raise ImageDecodeError("palette PNG has no PLTE")
    _check_size(w, h)
    channels = _PNG_CHANNELS[ctype]
    bits = depth * channels
    rowbytes = (w * bits + 7) // 8
    size = h * (rowbytes + 1)
    try:
        # inflate only the bytes the header describes; data past them is
        # ignored, as libpng ignores it (with a warning)
        data = zlib.decompressobj().decompress(b"".join(idat), size)
    except zlib.error as exc:
        raise ImageDecodeError(f"PNG data does not inflate: {exc}") from None
    if len(data) < size:
        raise ImageDecodeError("PNG data ends early")
    rows = np.frombuffer(data, np.uint8).reshape(h, rowbytes + 1)
    bpp = max(1, bits // 8)
    lines = unfilter_native(rows, bpp) if native else unfilter(rows[:, 1:], rows[:, 0], bpp)
    if depth == 16:
        samples = lines.view(">u2").astype(np.uint16).reshape(h, w, channels)
    elif depth == 8:
        samples = lines.reshape(h, w, channels)
    else:  # 1, 2 or 4 bits a sample, one channel
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        samples = ((lines[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if ctype == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        samples = samples[..., None]
    if ctype == 3:
        idx = samples[..., 0]
        if int(idx.max()) >= len(palette):
            raise ImageDecodeError("palette index outside PLTE")
        rgb = palette[idx]
    else:
        rgb = _to_rgb8(samples, channels)
    return upright(rgb, tiff_orientation(exif))


def png_row_filters(buf: bytes) -> np.ndarray:
    """The filter type (0-4) of each row of a non-interlaced PNG."""
    chunks = list(_png_chunks(buf))
    w, h, depth, ctype = struct.unpack(">IIBB", dict(chunks)[b"IHDR"][:10])
    rowbytes = (w * depth * _PNG_CHANNELS[ctype] + 7) // 8
    data = zlib.decompress(b"".join(d for k, d in chunks if k == b"IDAT"))
    return np.frombuffer(data, np.uint8, h * (rowbytes + 1))[::rowbytes + 1]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(image: np.ndarray, filters=None) -> bytes:
    """RGB (or gray [H, W]) uint8 image → 8-bit PNG bytes. Row r is written
    with filter ``filters[r % len(filters)]`` (0-4); by default (None) with
    the filter libpng chooses: the one whose residuals, read as signed
    bytes, have the least sum of magnitudes (Pillow chooses the same way
    but leaves Average out). A photo's rows get mostly Paeth and Up."""
    image = np.ascontiguousarray(image, np.uint8)
    gray = image.ndim == 2
    h, w = image.shape[:2]
    bpp = 1 if gray else 3
    lines = image.reshape(h, w * bpp).astype(np.int32)
    prev = np.zeros_like(lines)
    prev[1:] = lines[:-1]
    left = np.zeros_like(lines)
    left[:, bpp:] = lines[:, :-bpp]
    upleft = np.zeros_like(lines)
    upleft[1:, bpp:] = lines[:-1, :-bpp]
    preds = [np.zeros_like(lines), left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)]
    residuals = [(lines - p) & 255 for p in preds]
    if filters is None:
        cost = [np.minimum(res, 256 - res).sum(axis=1) for res in residuals]
        kinds = np.argmin(np.stack(cost), axis=0).astype(np.uint8)
    else:
        kinds = np.resize(np.asarray(filters, np.uint8), h)
    out = np.empty((h, w * bpp + 1), np.uint8)
    out[:, 0] = kinds
    for k in range(5):
        sel = kinds == k
        out[sel, 1:] = residuals[k][sel]
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(out.tobytes(), 6)) + _chunk(b"IEND", b""))


def encode_ppm(image: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] → binary PPM (P6) bytes."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + image.tobytes()
