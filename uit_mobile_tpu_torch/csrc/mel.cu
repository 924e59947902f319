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
// Design. Power never reaches device memory and no reduction crosses
// blocks: a block owns a tile of frame rows, walks all 512 packed DFT
// columns, squares each column chunk as it completes and folds it into the
// 64 mel accumulators; only the 64 log-mel values per row are written.
// Frames are read hop-strided straight from the reflect-padded wave (rows
// `pitch` samples apart): no frames tensor exists.
//   exact: BM=64 rows, 64-column chunks, FP32 FMA in registers over
//          shared-memory K steps (the simple first version);
//   fast:  wgmma with a producer warpgroup, an mbarrier ring of bulk-copied
//          G tiles and power kept in registers (see the fast section).
// Row order: the row layout tiles rows clip-major (r = b*n_frames + p); the
// transposed layout tiles them frame-major (r = p*B + b) so that its
// (n_frames, 64, B) store is contiguous along b. Each row's arithmetic is
// the same in both orders, so the two layouts are bitwise transposes.
// int16: samples are cast to float in the kernel (exact) and the host
// pre-scales G by 2^-15 (exact), so int16 input gives bitwise the output of
// wav.float()/32768. In fast mode, int16 and f32-from-int16 samples split
// into bf16 hi/lo exactly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
// tensor cores with f32 accumulation, as warpgroup MMAs (wgmma, sm_90a).
//
// What bounds it on this card. The three bf16 passes of both products are
// 3 x 589,824 FLOP a row: 46 us of tensor-core work at the serving shapes,
// against ~7 us of HBM traffic, so the kernel is bound by operations. What
// kept the first, wmma version at 6 % of that bound was everything around the
// products: frames re-read and re-split for each of 8 column chunks, G tiles
// copied by scalar loads behind two block barriers per 32-deep K step, and
// power staged through shared memory. The design keeps the tensor cores fed:
//
// - Tile. A block owns F_BM = 128 frame rows: two consumer warpgroups of 64
//   rows each, and one producer warpgroup. A consumer holds g for its 64
//   rows and 256 DFT columns (m64n256, 128 f32 registers a thread), so the
//   512 columns take two passes ("halves") and each frame sample is loaded
//   and split into bf16 hi/lo twice, not 8 times. Resident frames for the
//   whole K (64 rows x 512 x hi/lo = 128 KB a warpgroup) would leave no room
//   for the ring; streaming them twice costs 256 KB of L1/L2 reads a block.
// - Ring. Each of the 32 steps (2 halves x 16 K steps of 32) fills one stage
//   of a 3-stage ring: the producer copies the step's G tile (256 columns x
//   32 K, hi and lo: 32 KB) with one cp.async.bulk from a copy of G that the
//   host pre-packed in wgmma's K-major core-matrix order, and writes the
//   block's 128 frame-row slices (32 samples, split to hi/lo: 16 KB) with
//   vector stores. Full barriers count the producer's 128 arrivals and the
//   bulk copy's bytes; empty barriers the 8 consumer warps. No block-wide
//   barrier runs after set-up.
// - Producer. Each producer thread owns one tile row and loads its next
//   step's 32 samples before it waits for a free stage, so the load latency
//   (frame rows are scattered: frame-major tiles gather 128 clips) overlaps
//   the wait; without that the frames, not the tensor cores, set the pace.
//   setmaxnreg moves registers from the producer (88) to the consumers (208).
// - G from L2. The two consumer warpgroups share every G tile, so each G
//   byte is read from L2 once per 128 rows, not once per 64: ~230 MB a call
//   at 25.8k rows instead of ~460 MB.
// - Power in registers. At the end of a half, g is squared and split into
//   bf16 hi/lo in registers; the m64n256 accumulator's k16 slices are the
//   register A operand of m64n64k16 (the RS form), multiplied into the 64
//   mel accumulators against the half's filterbank (64 KB hi/lo, one bulk
//   copy per half into its own buffer).
// - Order. Every row runs the same instructions in the same K and column
//   order wherever it sits in a tile, so tfb is bitwise row-transposed and
//   int16 bitwise f32/32768 (G carries the 2^-15 scale).
// Layouts are K-major without swizzle: a core matrix is 8 rows x 16 bytes,
// 128 contiguous bytes; SBO steps 8 rows, LBO steps 8 K.
// Numerics. wgmma's f32 accumulation rounds differently from FP32 FMA, so
// where a DFT value cancels (mel 0, a filter over DFT bin 1 alone, in frame 0
// of a reflect-padded clip, whose sine part is zero) the kernel sits up to ~2
// float32 roundings of sum |F G| from a float64 sum of the same products,
// plain ~0.5: up to 7e-3 dB apart at -72 dB on the H100. fast_tolerance_db
// (ops/mel.py) holds the kernel to its plain version on that scale.
// What is left between it and its bound: one block per SM (208 KB of shared
// memory), so the ~200 blocks of the serving shapes take two rounds of 132
// SMs, the second about half full (64-row wgmma tiles give ~400 units, just
// over three per SM, so smaller tiles do not help); and ptxas serializes the wgmmas
// (see the mel product below).
constexpr int F_BM = 128;                       // frame rows per block
constexpr int F_HALF = 256;                     // DFT columns per accumulator pass
constexpr int F_HALVES = LANES / F_HALF;        // 2
constexpr int F_BK = 32;                        // K depth of a ring stage
constexpr int F_KSTEPS = N_FFT / F_BK;          // 16
constexpr int F_STEPS = F_HALVES * F_KSTEPS;    // 32
constexpr int F_STAGES = 3;
constexpr int F_THREADS = 384;                  // warpgroups 0, 1 consume; 2 produces
constexpr int F_A_BYTES = 64 * F_BK * 2;        // a warpgroup's frames, hi or lo: 4096
constexpr int F_G_BYTES = F_HALF * F_BK * 2;    // a G tile, hi or lo: 16384
constexpr int F_STAGE_BYTES = 4 * F_A_BYTES + 2 * F_G_BYTES;  // 49152
constexpr int F_FB_BYTES = N_MELS * F_HALF * 2;  // a filterbank half, hi or lo: 32768
constexpr int F_FB_OFF = F_STAGES * F_STAGE_BYTES;            // 147456
constexpr int F_BAR_OFF = F_FB_OFF + 2 * F_FB_BYTES;          // 212992
constexpr int F_SMEM_BYTES = F_BAR_OFF + 8 * (2 * F_STAGES + 2);  // 213056
constexpr int F_SBO = 128;                      // next 8 rows (every operand)
constexpr int F_A_LBO = 64 / 8 * 128;           // next 8 K: frames tile (64 rows)
constexpr int F_G_LBO = F_HALF / 8 * 128;       // next 8 K: G tile (256 columns)
constexpr int F_FB_LBO = N_MELS / 8 * 128;      // next 8 K: filterbank half (64 mels)
static_assert(F_SMEM_BYTES <= 232448, "fast kernel exceeds the 227 KB of shared memory");
// registers a thread after setmaxnreg: the block starts at 65536 / 384 -> 168
// a thread, the producer gives up what the consumers take
constexpr int F_PRODUCER_REGS = 88;
constexpr int F_CONSUMER_REGS = 208;
static_assert(128 * F_PRODUCER_REGS + 256 * F_CONSUMER_REGS <= 384 * 168,
              "setmaxnreg asks for more registers than the block holds");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: no swizzle, base offset 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(F_SBO >> 4) << 32;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// Bulk copy global -> shared; completion counted in bytes on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes across this point.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 256 f32, m64n256 accumulator layout) (+)= A (64 x 16, smem) * B (16 x 256, smem);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_256_ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers) * B (16 x 64, smem)
__device__ __forceinline__ void wgmma_64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (a, b) -> bf16x2 hi and lo words, low half = a, each rounded to nearest
// even exactly as the host's _bf16_split.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One K step of one frame row as loaded: F_BK samples in the input type's bits.
template <typename T>
struct RawStep {
    uint32_t w[F_BK * sizeof(T) / 4];
};

// The F_BK samples at src[k] (zeros for a row past the end): 16-byte loads
// where the row is aligned, else one load a sample.
template <typename T>
__device__ __forceinline__ void load_step(const T* src, bool vec, int k, RawStep<T>& r) {
    constexpr int W = F_BK * sizeof(T) / 4;
    if (src == nullptr) {
#pragma unroll
        for (int i = 0; i < W; ++i) r.w[i] = 0u;
    } else if (vec) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + k) + i);
            r.w[4 * i] = v.x; r.w[4 * i + 1] = v.y; r.w[4 * i + 2] = v.z; r.w[4 * i + 3] = v.w;
        }
    } else if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int i = 0; i < W; ++i)
            r.w[i] = static_cast<uint16_t>(__ldg(src + k + 2 * i)) |
                     static_cast<uint32_t>(static_cast<uint16_t>(__ldg(src + k + 2 * i + 1))) << 16;
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) r.w[i] = __float_as_uint(__ldg(src + k + i));
    }
}

__device__ __forceinline__ float sample(const RawStep<int16_t>& r, int e) {
    return static_cast<float>(static_cast<int16_t>(r.w[e / 2] >> (16 * (e % 2))));
}

__device__ __forceinline__ float sample(const RawStep<float>& r, int e) {
    return __uint_as_float(r.w[e]);
}

// gpack: G hi/lo pre-packed per step t = half * 16 + kstep as [hi tile | lo
// tile], each 256 columns x 32 K in K-major core-matrix order (2 x 16 KB).
// fbpack: the filterbank per half as [hi | lo], each 64 mels x 256 columns
// in the same order (2 x 32 KB). ops/mel.py:pack_fast_operands builds both.
template <typename T, bool TRANSPOSED>
__global__ void __launch_bounds__(F_THREADS, 1)
mel_fast_kernel(const T* __restrict__ wav, const __nv_bfloat16* __restrict__ gpack,
                const __nv_bfloat16* __restrict__ fbpack, float* __restrict__ out,
                int B, int pitch, int n_frames, int hop) {
    extern __shared__ __align__(128) unsigned char fast_smem[];
    const uint32_t sbase = smem_addr(fast_smem);
    const uint32_t full = sbase + F_BAR_OFF;        // full[s] at full + 8 s
    const uint32_t empty = full + 8 * F_STAGES;     // empty[s] at empty + 8 s
    const uint32_t fb_full = empty + 8 * F_STAGES;
    const uint32_t fb_empty = fb_full + 8;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < F_STAGES; ++s) {
            mbar_init(full + 8 * s, 128 + 1);  // producer threads + the bulk copy's arrive
            mbar_init(empty + 8 * s, 8);       // consumer warps
        }
        mbar_init(fb_full, 1);
        mbar_init(fb_empty, 8);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const long rows = static_cast<long>(B) * n_frames;
    const long row0 = static_cast<long>(blockIdx.x) * F_BM;
    const int wg = tid / 128;

    if (wg == 2) {
        // ---- producer: G/filterbank bulk copies, frames split into hi/lo
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(F_PRODUCER_REGS) : "memory");
        const int pr = tid - 256;  // the tile row whose frames this thread writes
        const long r = row0 + pr;
        const T* src = nullptr;
        if (r < rows) {
            int b, p;
            row_coords<TRANSPOSED>(r, B, n_frames, b, p);
            src = wav + static_cast<long>(b) * pitch + static_cast<long>(p) * hop;
        }
        const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
        // this row's 16-byte slot in its warpgroup's hi frames tile
        const uint32_t a_off = (pr / 64) * 2 * F_A_BYTES + ((pr % 64) / 8) * F_SBO + (pr % 8) * 16;
        // Frame samples are loaded one step ahead, so their latency overlaps
        // the wait for a free stage instead of following it.
        RawStep<T> raw;
        load_step(src, vec, 0, raw);
        for (int t = 0; t < F_STEPS; ++t) {
            const int half = t / F_KSTEPS, ks = t % F_KSTEPS, st = t % F_STAGES;
            uint32_t hi[F_BK / 2], lo[F_BK / 2];
#pragma unroll
            for (int j = 0; j < F_BK / 2; ++j)
                split2(sample(raw, 2 * j), sample(raw, 2 * j + 1), hi[j], lo[j]);
            if (t + 1 < F_STEPS) load_step(src, vec, (ks + 1) % F_KSTEPS * F_BK, raw);
            if (ks == F_STAGES - 1 && tid == 256) {
                // the half's filterbank, once the ring is primed; for the
                // second half this waits for the first half's mel product
                mbar_wait(fb_empty, (half & 1) ^ 1);
                mbar_arrive_tx(fb_full, 2 * F_FB_BYTES);
                bulk_load(sbase + F_FB_OFF, fbpack + half * F_FB_BYTES, 2 * F_FB_BYTES, fb_full);
            }
            mbar_wait(empty + 8 * st, ((t / F_STAGES) & 1) ^ 1);
            const uint32_t stage = sbase + st * F_STAGE_BYTES;
            if (tid == 256) {
                mbar_arrive_tx(full + 8 * st, 2 * F_G_BYTES);
                bulk_load(stage + 4 * F_A_BYTES, gpack + static_cast<long>(t) * F_G_BYTES,
                          2 * F_G_BYTES, full + 8 * st);
            }
#pragma unroll
            for (int c = 0; c < F_BK / 8; ++c) {
                const uint32_t dst = stage + a_off + c * F_A_LBO;
                st_shared_v4(dst, make_uint4(hi[4 * c], hi[4 * c + 1], hi[4 * c + 2], hi[4 * c + 3]));
                st_shared_v4(dst + F_A_BYTES,
                             make_uint4(lo[4 * c], lo[4 * c + 1], lo[4 * c + 2], lo[4 * c + 3]));
            }
            // the frames were written by the generic proxy; wgmma reads
            // through the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full + 8 * st);
        }
    } else {
        // ---- consumers: 64 rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(F_CONSUMER_REGS) : "memory");
        const int warp = (tid % 128) / 32, lane = tid % 32;
        float g[128];
        float mel[32];
#pragma unroll
        for (int i = 0; i < 128; ++i) g[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) mel[i] = 0.f;
        for (int half = 0; half < F_HALVES; ++half) {
            for (int ks = 0; ks < F_KSTEPS; ++ks) {
                const int t = half * F_KSTEPS + ks, st = t % F_STAGES;
                mbar_wait(full + 8 * st, (t / F_STAGES) & 1);
                const uint32_t a_hi = sbase + st * F_STAGE_BYTES + wg * 2 * F_A_BYTES;
                const uint32_t b_hi = sbase + st * F_STAGE_BYTES + 4 * F_A_BYTES;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < F_BK / 16; ++kk) {
                    const uint64_t ah = smem_desc(a_hi + kk * 2 * F_A_LBO, F_A_LBO);
                    const uint64_t al = smem_desc(a_hi + F_A_BYTES + kk * 2 * F_A_LBO, F_A_LBO);
                    const uint64_t bh = smem_desc(b_hi + kk * 2 * F_G_LBO, F_G_LBO);
                    const uint64_t bl = smem_desc(b_hi + F_G_BYTES + kk * 2 * F_G_LBO, F_G_LBO);
                    wgmma_256_ss(g, ah, bh, ks | kk);  // the half's first product overwrites g
                    wgmma_256_ss(g, ah, bl, 1);
                    wgmma_256_ss(g, al, bh, 1);
                }
                wgmma_commit();
                wgmma_wait<1>();  // the previous step's products are done: free its stage
                if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * ((t - 1) % F_STAGES));
            }
            wgmma_wait<0>();
            keep(g);
            if (lane == 0) mbar_arrive(empty + 8 * ((half * F_KSTEPS + F_KSTEPS - 1) % F_STAGES));
            // power = g^2, split into bf16 hi/lo in registers, one k16 slice
            // at a time: accumulator elements 8s..8s+7 are, pairwise, the A
            // fragment of the half's columns 16s..16s+15
            mbar_wait(fb_full, half & 1);
#pragma unroll
            for (int s = 0; s < F_HALF / 16; ++s) {
                uint32_t a_h[4], a_l[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float x0 = g[8 * s + 2 * i], x1 = g[8 * s + 2 * i + 1];
                    split2(x0 * x0, x1 * x1, a_h[i], a_l[i]);
                }
                const uint64_t fh = smem_desc(sbase + F_FB_OFF + s * 2 * F_FB_LBO, F_FB_LBO);
                const uint64_t fl = smem_desc(sbase + F_FB_OFF + F_FB_BYTES + s * 2 * F_FB_LBO,
                                              F_FB_LBO);
                wgmma_fence();
                wgmma_64_rs(mel, a_h, fh);
                wgmma_64_rs(mel, a_h, fl);
                wgmma_64_rs(mel, a_l, fh);
                // at most one slice in flight. ptxas still serializes the
                // kernel's wgmmas for want of registers (C7512), yet on the
                // H100 this order ran fastest: waiting for every slice
                // lifts the serialization but runs slower, and squaring all
                // of g in place before the products spills
                wgmma_commit();
                wgmma_wait<1>();
            }
            wgmma_wait<0>();
            keep(mel);
            if (lane == 0) mbar_arrive(fb_empty);
        }
        // dB and store: accumulator element 4j + 2i + c is row warp*16 + lane/4
        // + 8i, mel 8j + 2(lane%4) + c
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const long r = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
            if (r >= rows) continue;
            int b, p;
            row_coords<TRANSPOSED>(r, B, n_frames, b, p);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int m = 8 * j + 2 * (lane % 4);
                const float v0 = DB_SCALE * logf(fmaxf(mel[4 * j + 2 * i], AMIN));
                const float v1 = DB_SCALE * logf(fmaxf(mel[4 * j + 2 * i + 1], AMIN));
                if (TRANSPOSED) {
                    const long o = (static_cast<long>(p) * N_MELS + m) * B + b;
                    out[o] = v0;
                    out[o + B] = v1;
                } else {
                    *reinterpret_cast<float2*>(out + r * N_MELS + m) = make_float2(v0, v1);
                }
            }
        }
    }
}

template <typename T, bool TRANSPOSED>
int launch(bool fast, const void* wav, const void* g, const void* fb, float* out, int B,
           int pitch, int n_frames, int hop, cudaStream_t stream) {
    const long rows = static_cast<long>(B) * n_frames;
    const T* w = static_cast<const T*>(wav);
    if (fast) {
        // above 48 KB of dynamic shared memory only once allowed, once per instance
        static const cudaError_t attr = cudaFuncSetAttribute(
            mel_fast_kernel<T, TRANSPOSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            F_SMEM_BYTES);
        if (attr != cudaSuccess) return static_cast<int>(attr);
        const dim3 grid(static_cast<unsigned>((rows + F_BM - 1) / F_BM));
        mel_fast_kernel<T, TRANSPOSED><<<grid, F_THREADS, F_SMEM_BYTES, stream>>>(
            w, static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(fb),
            out, B, pitch, n_frames, hop);
    } else {
        const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM));
        mel_exact_kernel<T, TRANSPOSED><<<grid, THREADS, 0, stream>>>(
            w, static_cast<const float*>(g), static_cast<const float*>(fb), out, B, pitch,
            n_frames, hop);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wav:   reflect-padded rows, float32 or int16, `pitch` elements apart.
// exact: g = G (512, 512) f32, fb = filterbank rows (512, 64) f32.
// fast:  g = G hi/lo, fb = filterbank hi/lo, bf16, pre-packed as mel_fast_kernel
//        reads them (ops/mel.py:pack_fast_operands).
// out:   (B, n_frames, 64) or, transposed, (n_frames, 64, B) float32.
// Returns the launch's CUDA error (0 = success).
extern "C" int uit_log_mel(const void* wav, int in_int16, int fast, int transposed,
                           const void* g, const void* fb, void* out, int B, int pitch,
                           int n_frames, int hop, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    if (in_int16) {
        if (transposed) return launch<int16_t, true>(fast, wav, g, fb, o, B, pitch, n_frames, hop, s);
        return launch<int16_t, false>(fast, wav, g, fb, o, B, pitch, n_frames, hop, s);
    }
    if (transposed) return launch<float, true>(fast, wav, g, fb, o, B, pitch, n_frames, hop, s);
    return launch<float, false>(fast, wav, g, fb, o, B, pitch, n_frames, hop, s);
}

// Dynamic shared memory of one fast-kernel block, in bytes.
extern "C" int uit_mel_fast_smem_bytes() { return F_SMEM_BYTES; }
