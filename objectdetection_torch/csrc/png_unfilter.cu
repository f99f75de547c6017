// Undo PNG row filters on the host: the server's image decoder
// (objectdetection_torch/data/image_io.py) calls this through ctypes when it
// serves on the card. Host code only; no kernel, nothing runs on the device.
//
// Why C: byte (r, i) of a scanline depends on (r, i - bpp), (r - 1, i) and
// (r - 1, i - bpp) through the Average and Paeth predictors, whose floor and
// selection admit no scan. numpy (`image_io.unfilter`) walks the image's
// anti-diagonals, h + w steps of a dozen array operations each: ~0.3 s on
// one CPU core for a 1200x900 RGB PNG as Pillow or libpng write it. One
// sequential C loop touches each byte once.
//
// Contract (PNG 1.2 section 6): `rows` is the inflated image data, h rows of
// 1 + rowbytes bytes, the first byte of each its filter type (0 None, 1 Sub,
// 2 Up, 3 Average, 4 Paeth); `bpp` is the bytes a complete pixel spans,
// rounded up to 1; `out` receives the h x rowbytes unfiltered scanlines.
// Returns 0, or 1 + the index of the first row whose filter type is above 4
// (rows before it are written, it and later rows are not).

#include <cstdint>
#include <cstdlib>

extern "C" int64_t png_unfilter(const uint8_t* rows, int64_t h, int64_t rowbytes, int64_t bpp,
                                uint8_t* out) {
  const uint8_t* prior = nullptr;  // the row above, unfiltered; none above row 0
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t kind = rows[r * (rowbytes + 1)];
    const uint8_t* raw = rows + r * (rowbytes + 1) + 1;
    uint8_t* line = out + r * rowbytes;
    if (kind > 4) return r + 1;
    for (int64_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? line[i - bpp] : 0;             // left
      const int b = prior ? prior[i] : 0;                     // up
      const int c = prior && i >= bpp ? prior[i - bpp] : 0;   // up-left
      int pred = 0;
      switch (kind) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: break;
      }
      line[i] = static_cast<uint8_t>(raw[i] + pred);
    }
    prior = line;
  }
  return 0;
}
