// PNG scanline unfiltering (PNG specification, section 9.2).
//
// Each scanline of a decompressed PNG stream starts with one filter-type
// byte (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). Average and Paeth predict
// every byte from the already-reconstructed byte to its left, so a row is a
// sequential scan; encoders (libpng, ffmpeg, camera firmware) pick them for
// most rows of photographic frames. numpy cannot vectorise that scan, so it
// runs here.
//
// Build: compiled together with geodesic.cpp into the package's native
// library (slowflow_tpu/native/__init__.py).
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

// raw: h rows of (1 + stride) bytes; out: h rows of stride bytes; bpp: bytes
// per complete pixel (at least 1). Returns 0, or -1 - y for a bad filter
// type in row y.
extern "C" int png_unfilter(const uint8_t* raw, int h, int stride, int bpp,
                            uint8_t* out) {
  const uint8_t* prior = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
    const uint8_t ft = *line++;
    uint8_t* cur = out + static_cast<size_t>(y) * stride;
    if (ft > 4) return -1 - y;
    for (int i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prior ? prior[i] : 0;
      const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        default: pred = paeth(a, b, c); break;
      }
      cur[i] = static_cast<uint8_t>(line[i] + pred);
    }
    prior = cur;
  }
  return 0;
}
