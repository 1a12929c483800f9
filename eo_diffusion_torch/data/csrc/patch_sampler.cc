// Native patch sampler: the host-side hot path of the EO input pipeline.
//
// The reference's input pipeline (python/PIL/patchify) eagerly materializes
// full 5000^2 tiles and copies patches under the GIL (reference
// data_utils/data_load.py:159-207, 257-258). Feeding a TPU pod slice needs
// the host loop off the GIL: this library extracts patch batches from raw
// tile buffers with a worker-thread pool, fusing the window copy, the
// uint8->float32 conversion, value scaling ([0,1] or [-1,1]) and geometric
// flip augmentation into one pass over the output buffer.
//
// C API (ctypes-friendly):
//   eo_extract_patches_u8 / _f32:
//     tiles    : [n_tiles, tile_h, tile_w, C] contiguous source buffer
//     jobs     : [n_patches, 4] int64 (tile_idx, row_off, col_off, flip_bits)
//                flip_bits: bit0 = horizontal flip, bit1 = vertical flip
//     out      : [n_patches, size, size, C] float32
//     scale/bias: out = src * scale + bias  (e.g. 1/255, 0 -> [0,1];
//                 2/255, -1 -> [-1,1])
//     n_threads: worker threads (0 = hardware concurrency)
//
// Build: eo_diffusion_torch/data/native.py compiles this file with
// tiff_reader.cc into one library (g++ -O3 -march=native -shared -fPIC -lz).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename T>
void extract_one(const T* tiles, int64_t tile_h, int64_t tile_w, int64_t ch,
                 const int64_t* job, float* out, int64_t size, float scale,
                 float bias) {
  const int64_t tile_idx = job[0];
  const int64_t row_off = job[1];
  const int64_t col_off = job[2];
  const int64_t flip = job[3];
  const bool hflip = flip & 1;
  const bool vflip = flip & 2;

  const T* src_tile = tiles + tile_idx * tile_h * tile_w * ch;
  const int64_t row_stride = tile_w * ch;

  for (int64_t r = 0; r < size; ++r) {
    const int64_t src_r = row_off + (vflip ? (size - 1 - r) : r);
    const T* src_row = src_tile + src_r * row_stride + col_off * ch;
    float* dst_row = out + r * size * ch;
    if (!hflip) {
      for (int64_t i = 0; i < size * ch; ++i) {
        dst_row[i] = static_cast<float>(src_row[i]) * scale + bias;
      }
    } else {
      for (int64_t c = 0; c < size; ++c) {
        const T* s = src_row + (size - 1 - c) * ch;
        float* d = dst_row + c * ch;
        for (int64_t k = 0; k < ch; ++k) {
          d[k] = static_cast<float>(s[k]) * scale + bias;
        }
      }
    }
  }
}

template <typename T>
void extract_batch(const T* tiles, int64_t n_tiles, int64_t tile_h,
                   int64_t tile_w, int64_t ch, const int64_t* jobs,
                   int64_t n_patches, float* out, int64_t size, float scale,
                   float bias, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads == 1 || n_patches == 1) {
    for (int64_t p = 0; p < n_patches; ++p) {
      extract_one(tiles, tile_h, tile_w, ch, jobs + p * 4,
                  out + p * size * size * ch, size, scale, bias);
    }
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int w = 0; w < n_threads; ++w) {
    workers.emplace_back([&]() {
      int64_t p;
      while ((p = next.fetch_add(1)) < n_patches) {
        extract_one(tiles, tile_h, tile_w, ch, jobs + p * 4,
                    out + p * size * size * ch, size, scale, bias);
      }
    });
  }
  for (auto& t : workers) t.join();
}

}  // namespace

extern "C" {

void eo_extract_patches_u8(const uint8_t* tiles, int64_t n_tiles,
                           int64_t tile_h, int64_t tile_w, int64_t ch,
                           const int64_t* jobs, int64_t n_patches, float* out,
                           int64_t size, float scale, float bias,
                           int n_threads) {
  extract_batch(tiles, n_tiles, tile_h, tile_w, ch, jobs, n_patches, out,
                size, scale, bias, n_threads);
}

void eo_extract_patches_f32(const float* tiles, int64_t n_tiles,
                            int64_t tile_h, int64_t tile_w, int64_t ch,
                            const int64_t* jobs, int64_t n_patches, float* out,
                            int64_t size, float scale, float bias,
                            int n_threads) {
  extract_batch(tiles, n_tiles, tile_h, tile_w, ch, jobs, n_patches, out,
                size, scale, bias, n_threads);
}

int eo_version() { return 1; }

}  // extern "C"
