// libuitdata — native host data plane for uit_mobile_tpu_torch.
//
// The reference leans on native code through its dependencies for the
// host-side data path (libsox wav decode in torchaudio, torch's C++
// DataLoader machinery, int16 conversion in torch kernels). This library
// is the framework-owned equivalent: a dependency-free RIFF/WAV parser,
// vectorizable int16->float32 conversion, multithreaded padded-batch
// assembly, and random-crop/pad — the per-batch hot path between HDF5/disk
// and the copy to the card.
//
// Exposed as a plain C ABI consumed via ctypes (uit_mobile_tpu_torch/native/
// __init__.py); every function is thread-safe and allocation-free (callers
// own all buffers).
//
// Build: python -m uit_mobile_tpu_torch.native.build (g++, into uit_mobile_tpu_torch/_build/)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------- wav decode

// Parse a RIFF/WAVE byte buffer holding 16-bit PCM. Returns 0 on success.
// On success *out_data points INTO buf (zero-copy), *out_frames is the
// per-channel sample count, *out_channels / *out_sample_rate filled in.
// Error codes: 1 bad header, 2 no fmt chunk, 3 unsupported codec,
// 4 no data chunk.
int uit_parse_wav16(const uint8_t* buf, int64_t len,
                    const int16_t** out_data, int64_t* out_frames,
                    int32_t* out_channels, int32_t* out_sample_rate) {
  if (len < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0) {
    return 1;
  }
  int64_t pos = 12;
  int32_t channels = 0, sample_rate = 0, bits = 0;
  uint16_t codec = 0;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_len;
    std::memcpy(&chunk_len, hdr + 4, 4);
    const uint8_t* body = hdr + 8;
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16 &&
        pos + 8 + chunk_len <= static_cast<uint64_t>(len)) {
      uint16_t ch16, bits16;
      uint32_t sr32;
      std::memcpy(&codec, body, 2);
      std::memcpy(&ch16, body + 2, 2);
      std::memcpy(&sr32, body + 4, 4);
      std::memcpy(&bits16, body + 14, 2);
      channels = ch16;
      sample_rate = static_cast<int32_t>(sr32);
      bits = bits16;
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      if (!have_fmt) return 2;
      if ((codec != 1 && codec != 0xFFFE) || bits != 16) return 3;
      int64_t avail = std::min<int64_t>(chunk_len, len - pos - 8);
      *out_data = reinterpret_cast<const int16_t*>(body);
      *out_frames = avail / 2 / std::max(channels, 1);
      *out_channels = channels;
      *out_sample_rate = sample_rate;
      return 0;
    }
    // Advance in 64-bit: `8 + chunk_len` in uint32 wraps for chunk_len
    // near UINT32_MAX (pos += 0 -> infinite loop on untrusted bytes).
    pos += 8 + static_cast<int64_t>(chunk_len) + (chunk_len & 1);  // word-aligned
  }
  return 4;
}

// ------------------------------------------------------------ pcm conversion

// int16 PCM -> float32 in [-1, 1) (the reference's /32768 convention,
// dataset.py:44-45).
void uit_pcm16_to_f32(const int16_t* src, float* dst, int64_t n) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * kScale;
}

// ------------------------------------------------------------ batch assembly

}  // extern "C" (helper below is C++-only; wrappers re-enter the C ABI)

// Shared scaffold: fan rows out over `threads` std::threads, each row
// produced by copy_row(src, dst, n) then zero-tailed to max_len.
template <typename In, typename Out, typename CopyRow>
static void pad_batch_threaded(const In** clips, const int64_t* lengths,
                               int64_t b, int64_t max_len, Out* out,
                               int32_t threads, CopyRow copy_row) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Out* row = out + i * max_len;
      int64_t n = std::min(lengths[i], max_len);
      copy_row(clips[i], row, n);
      std::memset(row + n, 0, sizeof(Out) * (max_len - n));
    }
  };
  if (threads <= 1 || b <= 1) {
    work(0, b);
    return;
  }
  int32_t t = std::min<int64_t>(threads, b);
  std::vector<std::thread> pool;
  int64_t chunk = (b + t - 1) / t;
  for (int32_t k = 0; k < t; ++k) {
    int64_t lo = k * chunk, hi = std::min<int64_t>(b, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

extern "C" {

// Assemble a right-zero-padded float32 batch from `b` int16 clips of
// lengths[i] samples each, writing into out (b x max_len). int16->f32
// conversion fused into the copy.
void uit_pad_batch_pcm16(const int16_t** clips, const int64_t* lengths,
                         int64_t b, int64_t max_len, float* out,
                         int32_t threads) {
  pad_batch_threaded(clips, lengths, b, max_len, out, threads,
                     [](const int16_t* src, float* dst, int64_t n) {
                       uit_pcm16_to_f32(src, dst, n);
                     });
}

// Float variant (already-decoded clips).
void uit_pad_batch_f32(const float** clips, const int64_t* lengths,
                       int64_t b, int64_t max_len, float* out,
                       int32_t threads) {
  pad_batch_threaded(clips, lengths, b, max_len, out, threads,
                     [](const float* src, float* dst, int64_t n) {
                       std::memcpy(dst, src, sizeof(float) * n);
                     });
}

// int16-in, int16-out variant: no conversion at all — serving/eval ship
// raw PCM to the device and the frontends fold the 1/32768 scale in.
void uit_pad_batch_i16(const int16_t** clips, const int64_t* lengths,
                       int64_t b, int64_t max_len, int16_t* out,
                       int32_t threads) {
  pad_batch_threaded(clips, lengths, b, max_len, out, threads,
                     [](const int16_t* src, int16_t* dst, int64_t n) {
                       std::memcpy(dst, src, sizeof(int16_t) * n);
                     });
}

// ---------------------------------------------------------------- multi-hot

// Scatter label index lists into a zeroed multi-hot matrix (b x n_classes).
// offsets[i]..offsets[i+1] delimit sample i's indices in `labels`.
void uit_multihot(const int32_t* labels, const int64_t* offsets, int64_t b,
                  int32_t n_classes, float* out) {
  std::memset(out, 0, sizeof(float) * b * n_classes);
  for (int64_t i = 0; i < b; ++i) {
    float* row = out + i * n_classes;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      int32_t c = labels[j];
      if (c >= 0 && c < n_classes) row[c] = 1.0f;
    }
  }
}

int32_t uit_version() { return 2; }  // 2: + uit_pad_batch_i16

}  // extern "C"
