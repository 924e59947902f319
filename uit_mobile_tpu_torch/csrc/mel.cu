// Fused log-mel frontend for Hopper (sm_90a): framing -> window-folded
// packed real DFT -> power -> mel filterbank -> 10*log10, one kernel.
//
// Replaces the four Pallas kernels of uit_mobile_tpu/ops/pallas_mel.py:
//   _mel_kernel (:101, row, exact)      _mel_kernel_fast (:142, row, fast)
//   _mel_kernel_t (:180, tfb, exact)    _mel_kernel_fast_t (:192, tfb, fast)
// They are one computation with two switches, so here they are one kernel
// template: PRECISION (exact FP32 FMA | fast 3-pass bf16 hi/lo split on the
// tensor cores), input type (float | int16 PCM) and output layout (row
// (B, n_frames, 64) | transposed (n_frames, 64, B)).
//
// What bounds it. One frame row costs 2*512*512 + 2*512*64 = 589,824 FLOP
// and moves at most 512 input samples and 64 output floats, so at the
// serving shape (B=256 one-second clips, 101 frames) it is 15.3 GFLOP
// against ~23.5 MB (f32 in; ~15 MB int16 in), about 7 us at 3.35 TB/s.
// The kernel is bound by operations, not bytes:
//   exact: 15.3 GFLOP at the H100 SXM's 67 TFLOP/s FP32 (non-tensor) rate
//          -> ~0.23 ms;
//   fast:  3 x 15.3 GFLOP of bf16 products at 989 TFLOP/s -> ~0.046 ms.
// Measured times sit beside these bounds in PERF.md.
//
// Design. A block owns BM=64 frame rows and walks all 512 packed DFT
// columns in chunks of BN=64. For each chunk it accumulates g = frames @ G
// over K=512 in registers (exact) or wmma fragments (fast), squares it,
// stages the power in shared memory and immediately multiplies it into the
// 64 mel accumulators with the matching 64 filterbank rows. Power never
// reaches device memory and no reduction crosses blocks; only the 64
// log-mel values per row are written. Frames are read hop-strided straight
// from the reflect-padded wave (B, Tp): no frames tensor exists.
// Row order: the row layout tiles rows clip-major (r = b*n_frames + p); the
// transposed layout tiles them frame-major (r = p*B + b) so that its
// (n_frames, 64, B) store is contiguous along b. Each row's arithmetic is
// the same in both orders, so the two layouts are bitwise transposes.
// int16: samples are cast to float in the kernel (exact) and the host
// pre-scales G by 2^-15 (exact), so int16 input gives bitwise the output of
// wav.float()/32768. In fast mode, int16 and f32-from-int16 samples split
// into bf16 hi/lo exactly.
// This is the simple first version: no TMA, no wgmma, no pipelining.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int N_FFT = 512;   // frame length (K of the DFT product)
constexpr int LANES = 512;   // packed [Re | Im] DFT columns
constexpr int N_MELS = 64;
constexpr int BM = 64;       // frame rows per block
constexpr int BN = 64;       // packed DFT columns per chunk
constexpr int BK = 32;       // K step of the DFT product
constexpr int THREADS = 256;
constexpr float DB_SCALE = 4.342944819032518f;  // 10 / ln(10)
constexpr float AMIN = 1e-10f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int16_t x) { return static_cast<float>(x); }

// (b, p) of tile row r: clip-major for the row layout, frame-major for the
// transposed one.
template <bool TRANSPOSED>
__device__ __forceinline__ void row_coords(long r, int B, int n_frames, int& b, int& p) {
    if (TRANSPOSED) {
        p = static_cast<int>(r / B);
        b = static_cast<int>(r - static_cast<long>(p) * B);
    } else {
        b = static_cast<int>(r / n_frames);
        p = static_cast<int>(r - static_cast<long>(b) * n_frames);
    }
}

// Write a BM x N_MELS tile of dB values, staged in shared memory S (leading
// dimension lds), with stores contiguous along the output's minor axis.
template <bool TRANSPOSED>
__device__ __forceinline__ void store_tile(const float* S, int lds, float* __restrict__ out,
                                           long row0, long rows, int B, int n_frames) {
    for (int i = threadIdx.x; i < BM * N_MELS; i += THREADS) {
        int rl, m;
        if (TRANSPOSED) { m = i / BM; rl = i % BM; } else { rl = i / N_MELS; m = i % N_MELS; }
        const long r = row0 + rl;
        if (r >= rows) continue;
        int b, p;
        row_coords<TRANSPOSED>(r, B, n_frames, b, p);
        const long o = TRANSPOSED ? (static_cast<long>(p) * N_MELS + m) * B + b
                                  : r * N_MELS + m;
        out[o] = S[rl * lds + m];
    }
}

// Per-thread A-tile loader state: thread loads column tid % BK of the rows
// tid / BK + 8*i (i < 8) of each BM x BK frame tile.
constexpr int LOAD_ROWS = BM / (THREADS / BK);  // 8

template <bool TRANSPOSED>
__device__ __forceinline__ void frame_bases(long row0, long rows, int B, int n_frames,
                                            int Tp, int hop, long* base) {
    const int lm0 = threadIdx.x / BK;
#pragma unroll
    for (int i = 0; i < LOAD_ROWS; ++i) {
        const long r = row0 + lm0 + (THREADS / BK) * i;
        if (r < rows) {
            int b, p;
            row_coords<TRANSPOSED>(r, B, n_frames, b, p);
            base[i] = static_cast<long>(b) * Tp + static_cast<long>(p) * hop;
        } else {
            base[i] = -1;  // ragged edge: zero rows, never stored
        }
    }
}

// ---------------------------------------------------------------- exact
// DFT product in FP32 FMA (TF32 is too coarse: the DFT cancels at spectral
// valleys); filterbank product in FP32 as well.
constexpr int EX_LDA = BK + 1;   // As [BM][BK+1]
constexpr int EX_LDP = BN + 1;   // Ps [BM][BN+1]
constexpr int EX_SMEM_FLOATS = BM * EX_LDP + BN * N_MELS;  // phase 2 is the larger

template <typename T, bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS)
mel_exact_kernel(const T* __restrict__ wav, const float* __restrict__ G,
                 const float* __restrict__ fb, float* __restrict__ out,
                 int B, int Tp, int n_frames, int hop) {
    __shared__ float smem[EX_SMEM_FLOATS];
    float* As = smem;                       // phase 1: [BM][EX_LDA]
    float* Bs = smem + BM * EX_LDA;         //          [BK][BN]
    float* Ps = smem;                       // phase 2: [BM][EX_LDP] (aliases phase 1)
    float* Fs = smem + BM * EX_LDP;         //          [BN][N_MELS]

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;  // 4x4 micro-tile per thread
    const long rows = static_cast<long>(B) * n_frames;
    const long row0 = static_cast<long>(blockIdx.x) * BM;
    const int lk = tid % BK, lm0 = tid / BK;
    long base[LOAD_ROWS];
    frame_bases<TRANSPOSED>(row0, rows, B, n_frames, Tp, hop, base);

    float mel[4][4] = {};
    for (int nc = 0; nc < LANES; nc += BN) {
        float g[4][4] = {};
        for (int kc = 0; kc < N_FFT; kc += BK) {
#pragma unroll
            for (int i = 0; i < LOAD_ROWS; ++i)
                As[(lm0 + (THREADS / BK) * i) * EX_LDA + lk] =
                    base[i] >= 0 ? to_f32(wav[base[i] + kc + lk]) : 0.f;
#pragma unroll
            for (int i = tid; i < BK * BN; i += THREADS)
                Bs[i] = G[(kc + i / BN) * LANES + nc + i % BN];
            __syncthreads();
#pragma unroll 8
            for (int k = 0; k < BK; ++k) {
                float a[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * EX_LDA + k];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = Bs[k * BN + tx * 4 + j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], bv[j], g[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Ps[(ty * 4 + i) * EX_LDP + tx * 4 + j] = g[i][j] * g[i][j];
        for (int i = tid; i < BN * N_MELS; i += THREADS)
            Fs[i] = fb[nc * N_MELS + i];
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < BN; ++c) {
            float pw[4], f[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pw[i] = Ps[(ty * 4 + i) * EX_LDP + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) f[j] = Fs[c * N_MELS + tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) mel[i][j] = fmaf(pw[i], f[j], mel[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            Ps[(ty * 4 + i) * EX_LDP + tx * 4 + j] = DB_SCALE * logf(fmaxf(mel[i][j], AMIN));
    __syncthreads();
    store_tile<TRANSPOSED>(Ps, EX_LDP, out, row0, rows, B, n_frames);
}

// ----------------------------------------------------------------- fast
// Both products as 3-pass bf16 hi/lo splits (hi*hi + hi*lo + lo*hi) on the
// tensor cores, wmma 16x16x16 with FP32 accumulation. The host pre-splits G
// and the filterbank; the kernel splits frames and power itself. Eight
// warps: warp w owns rows 16*(w%4).. of the tile and a 32-wide half
// (w/4) of each DFT column chunk and of the 64 mels.
constexpr int FA_LDA = BK + 8;   // bf16 [BM][BK+8]
constexpr int FA_LDB = BN + 8;   // bf16 [BK][BN+8]
constexpr int FA_LDP = BN + 4;   // f32  [BM][BN+4]
constexpr int FA_LDH = BN + 8;   // bf16 [BM][BN+8]
constexpr int FA_PHASE1_BYTES = 2 * BM * FA_LDA * 2 + 2 * BK * FA_LDB * 2;  // 19456
constexpr int FA_PS_BYTES = BM * FA_LDP * 4;                                  // 17408
constexpr int FA_STAGE_BYTES = FA_PHASE1_BYTES > FA_PS_BYTES ? FA_PHASE1_BYTES : FA_PS_BYTES;
constexpr int FA_SMEM_BYTES = FA_STAGE_BYTES + 2 * BM * FA_LDH * 2;          // 37888

__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(x);
    lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

template <typename T, bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS)
mel_fast_kernel(const T* __restrict__ wav,
                const __nv_bfloat16* __restrict__ Ghi, const __nv_bfloat16* __restrict__ Glo,
                const __nv_bfloat16* __restrict__ fbhi, const __nv_bfloat16* __restrict__ fblo,
                float* __restrict__ out, int B, int Tp, int n_frames, int hop) {
    __shared__ __align__(128) unsigned char smem[FA_SMEM_BYTES];
    __nv_bfloat16* Ah = reinterpret_cast<__nv_bfloat16*>(smem);   // phase 1
    __nv_bfloat16* Al = Ah + BM * FA_LDA;
    __nv_bfloat16* Bh = Al + BM * FA_LDA;
    __nv_bfloat16* Bl = Bh + BK * FA_LDB;
    float* Ps = reinterpret_cast<float*>(smem);                   // phase 2 (aliases phase 1)
    __nv_bfloat16* Ph = reinterpret_cast<__nv_bfloat16*>(smem + FA_STAGE_BYTES);
    __nv_bfloat16* Pl = Ph + BM * FA_LDH;

    const int tid = threadIdx.x;
    const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
    const long rows = static_cast<long>(B) * n_frames;
    const long row0 = static_cast<long>(blockIdx.x) * BM;
    const int lk = tid % BK, lm0 = tid / BK;
    long base[LOAD_ROWS];
    frame_bases<TRANSPOSED>(row0, rows, B, n_frames, Tp, hop, base);

    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

    FragC mel[2];
    wmma::fill_fragment(mel[0], 0.f);
    wmma::fill_fragment(mel[1], 0.f);
    for (int nc = 0; nc < LANES; nc += BN) {
        FragC g[2];
        wmma::fill_fragment(g[0], 0.f);
        wmma::fill_fragment(g[1], 0.f);
        for (int kc = 0; kc < N_FFT; kc += BK) {
#pragma unroll
            for (int i = 0; i < LOAD_ROWS; ++i) {
                const float x = base[i] >= 0 ? to_f32(wav[base[i] + kc + lk]) : 0.f;
                const int o = (lm0 + (THREADS / BK) * i) * FA_LDA + lk;
                split_bf16(x, Ah[o], Al[o]);
            }
#pragma unroll
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int src = (kc + i / BN) * LANES + nc + i % BN;
                const int dst = (i / BN) * FA_LDB + i % BN;
                Bh[dst] = Ghi[src];
                Bl[dst] = Glo[src];
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                FragA ah, al;
                wmma::load_matrix_sync(ah, Ah + wm * 16 * FA_LDA + kk, FA_LDA);
                wmma::load_matrix_sync(al, Al + wm * 16 * FA_LDA + kk, FA_LDA);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    FragB bh, bl;
                    wmma::load_matrix_sync(bh, Bh + kk * FA_LDB + wn * 32 + j * 16, FA_LDB);
                    wmma::load_matrix_sync(bl, Bl + kk * FA_LDB + wn * 32 + j * 16, FA_LDB);
                    wmma::mma_sync(g[j], ah, bh, g[j]);
                    wmma::mma_sync(g[j], ah, bl, g[j]);
                    wmma::mma_sync(g[j], al, bh, g[j]);
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int t = 0; t < g[j].num_elements; ++t) g[j].x[t] *= g[j].x[t];
            wmma::store_matrix_sync(Ps + wm * 16 * FA_LDP + wn * 32 + j * 16, g[j], FA_LDP,
                                    wmma::mem_row_major);
        }
        __syncthreads();
        for (int i = tid; i < BM * BN; i += THREADS) {
            const int r = i / BN, c = i % BN;
            split_bf16(Ps[r * FA_LDP + c], Ph[r * FA_LDH + c], Pl[r * FA_LDH + c]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BN; kk += 16) {
            FragA ph, pl;
            wmma::load_matrix_sync(ph, Ph + wm * 16 * FA_LDH + kk, FA_LDH);
            wmma::load_matrix_sync(pl, Pl + wm * 16 * FA_LDH + kk, FA_LDH);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                FragB fh, fl;
                const int off = (nc + kk) * N_MELS + wn * 32 + j * 16;
                wmma::load_matrix_sync(fh, fbhi + off, N_MELS);
                wmma::load_matrix_sync(fl, fblo + off, N_MELS);
                wmma::mma_sync(mel[j], ph, fh, mel[j]);
                wmma::mma_sync(mel[j], ph, fl, mel[j]);
                wmma::mma_sync(mel[j], pl, fh, mel[j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int t = 0; t < mel[j].num_elements; ++t)
            mel[j].x[t] = DB_SCALE * logf(fmaxf(mel[j].x[t], AMIN));
        wmma::store_matrix_sync(Ps + wm * 16 * FA_LDP + wn * 32 + j * 16, mel[j], FA_LDP,
                                wmma::mem_row_major);
    }
    __syncthreads();
    store_tile<TRANSPOSED>(Ps, FA_LDP, out, row0, rows, B, n_frames);
}

template <typename T, bool TRANSPOSED>
void launch(bool fast, const void* wav, const void* g, const void* g_lo, const void* fb,
            const void* fb_lo, float* out, int B, int Tp, int n_frames, int hop,
            cudaStream_t stream) {
    const long rows = static_cast<long>(B) * n_frames;
    const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM));
    const T* w = static_cast<const T*>(wav);
    if (fast) {
        mel_fast_kernel<T, TRANSPOSED><<<grid, THREADS, 0, stream>>>(
            w, static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(g_lo),
            static_cast<const __nv_bfloat16*>(fb), static_cast<const __nv_bfloat16*>(fb_lo),
            out, B, Tp, n_frames, hop);
    } else {
        mel_exact_kernel<T, TRANSPOSED><<<grid, THREADS, 0, stream>>>(
            w, static_cast<const float*>(g), static_cast<const float*>(fb), out, B, Tp,
            n_frames, hop);
    }
}

}  // namespace

// wav: reflect-padded (B, Tp) float32 or int16, contiguous.
// exact: g = G (512, 512) f32, fb = filterbank rows (512, 64) f32; g_lo/fb_lo unused.
// fast:  g/g_lo = bf16 hi/lo of G, fb/fb_lo = bf16 hi/lo of the filterbank rows.
// out:   (B, n_frames, 64) or, transposed, (n_frames, 64, B) float32.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int uit_log_mel(const void* wav, int in_int16, int fast, int transposed,
                           const void* g, const void* g_lo, const void* fb, const void* fb_lo,
                           void* out, int B, int Tp, int n_frames, int hop, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    if (in_int16) {
        if (transposed) launch<int16_t, true>(fast, wav, g, g_lo, fb, fb_lo, o, B, Tp, n_frames, hop, s);
        else launch<int16_t, false>(fast, wav, g, g_lo, fb, fb_lo, o, B, Tp, n_frames, hop, s);
    } else {
        if (transposed) launch<float, true>(fast, wav, g, g_lo, fb, fb_lo, o, B, Tp, n_frames, hop, s);
        else launch<float, false>(fast, wav, g, g_lo, fb, fb_lo, o, B, Tp, n_frames, hop, s);
    }
    return static_cast<int>(cudaGetLastError());
}
