// Fused log-mel frontend for Hopper (sm_90a): framing -> window-folded
// packed real DFT -> power -> mel filterbank -> 10*log10, one kernel.
//
// Replaces the four Pallas kernels of uit_mobile_tpu/ops/pallas_mel.py:
//   _mel_kernel (:101, row, exact)      _mel_kernel_fast (:142, row, fast)
//   _mel_kernel_t (:180, tfb, exact)    _mel_kernel_fast_t (:192, tfb, fast)
// They are one computation with three switches, so here they are one kernel
// template, mel_kernel<T, TRANSPOSED, PASSES>: input type (float | int16
// PCM), output layout (row (B, n_frames, 64) | transposed (n_frames, 64,
// B)) and the DFT's bf16 passes on the tensor cores:
//   fast  (PASSES 3): each DFT operand split into bf16 hi + lo, products
//         hh, hl, lh (the Pallas kernels' _tri_dot);
//   exact (PASSES 6): each split into bf16 hi + mid + lo, products hh, hm,
//         mh, hl, lh, mm: what Precision.HIGHEST runs on the TPU's MXU. The
//         dropped ml, lm, ll are ~2^-26 of each product, below float32's
//         own rounding, so the DFT is FP32-grade. The five lower-order
//         products sweep K before hh does (Accumulation, below).
// Both run the filterbank product as the 3-pass hi/lo split, as both
// Pallas kernels do (pallas_mel.py:124, :151).
//
// What bounds it. One frame row is 2*512*512 DFT + 2*512*64 filterbank
// FLOP and moves at most 512 input samples and 64 output floats: at B=256
// one-second clips (101 frames) 13.56 + 1.69 GFLOP against ~23.5 MB (f32
// in), about 7 us at 3.35 TB/s. The kernel is bound by the tensor cores:
//   fast:  3 x (13.56 + 1.69) GFLOP of bf16 products at 989 TFLOP/s -> 0.046 ms;
//   exact: (6 x 13.56 + 3 x 1.69) GFLOP -> 0.087 ms (the same work as FP32
//          FMA at 67 TFLOP/s would take 0.228 ms).
// Measured times sit beside these bounds in PERF.md.
//
// Design. Power never reaches device memory and no reduction crosses
// blocks. A block owns BM = 128 frame rows: two consumer warpgroups of 64
// rows each, and one producer warpgroup. Frames are read hop-strided
// straight from the reflect-padded wave (rows `pitch` samples apart): no
// frames tensor exists.
// - Accumulator. A consumer holds g for its 64 rows and 256 DFT columns
//   (wgmma m64n256, 128 f32 registers a thread), so the 512 columns take two
//   halves and each frame sample is loaded and split twice. Resident frames
//   for the whole K (64 rows x 512 x NP pieces a warpgroup) would leave no
//   room for the ring.
// - Ring. Each step (2 halves x N_FFT / BK K steps, twice over for exact)
//   fills one stage: the
//   producer copies the step's G tile (256 columns x BK K, one tile per
//   bf16 piece) with one cp.async.bulk from a copy of G that the host
//   pre-packed in wgmma's K-major core-matrix order (ops/mel.py:
//   pack_operands), and writes the block's 128 frame-row slices, split
//   into the same pieces, with vector stores. Full barriers count the
//   producer's 128 arrivals and the bulk copy's bytes; empty barriers the 8
//   consumer warps. No block-wide barrier runs after set-up.
// - Producer. Each producer thread owns one tile row and loads its next
//   step's samples before it waits for a free stage, so the load latency
//   (frame rows are scattered: frame-major tiles gather 128 clips) overlaps
//   the wait. setmaxnreg moves registers from the producer (88) to the
//   consumers (208).
// - G from L2. The two consumer warpgroups share every G tile, so each G
//   byte is read from L2 once per 128 rows, not once per 64.
// - Power in registers. At the end of a half, g is squared and split into
//   bf16 hi/lo in registers; the m64n256 accumulator's k16 slices are the
//   register A operand of m64n64k16 (the RS form), multiplied into the 64
//   mel accumulators against the half's filterbank (64 KB hi/lo, one bulk
//   copy per half into its own buffer, issued once the ring is full).
// - Order. Every row runs the same instructions in the same K, piece and
//   column order wherever it sits in a tile, so tfb is bitwise
//   row-transposed (the row layout tiles rows clip-major, r = b*n_frames +
//   p; the transposed one frame-major, r = p*B + b, so that its store is
//   contiguous along b). int16 input is bitwise wav.float()/32768: the host
//   pre-scales G by 2^-15 (exact), and a PCM sample, as an integer or
//   divided by 32768, has at most 16 significant bits, so it splits exactly
//   into hi + lo (fast) or hi + mid with lo = 0 (exact) in either form.
// Layouts are K-major without swizzle: a core matrix is 8 rows x 16 bytes,
// 128 contiguous bytes; SBO steps 8 rows, LBO steps 8 K.
//
// Budget of the exact instances, and what was likely to go wrong:
// - Shared memory. A 32-deep exact stage would be 72 KB (frames 3 pieces x
//   2 warpgroups x 4 KB, G 3 x 16 KB): two stages plus the 64 KB filterbank
//   fill the same 213 KB as the fast kernel's three 48 KB stages. Exact
//   takes four 16-deep stages (36 KB each) instead, the same bytes in
//   flight: a freed stage is refilled three steps ahead (~2.5 us of tensor
//   work at the data-sheet rate) rather than one (~1.7 us), so the bulk
//   copy's L2 latency hides behind more products. One block per SM either
//   way.
// - Serialized wgmmas. ptxas serializes the fast instances' wgmmas for want
//   of registers (C7512); the exact instances issue six SS wgmmas per k16
//   instead of three and need no more registers for them (descriptors
//   only). chip_smoke.py's build line reports each instance.
// - Accumulation. wgmma rounds each f32 sum at the accumulator's
//   magnitude, more coarsely than FP32 FMA: where a DFT value cancels (mel
//   0, a filter over DFT bin 1 alone, in frame 0 of a reflect-padded clip,
//   whose sine part is zero) that shows against sum |F G|. With hh first
//   in every k16, all 192 wgmmas of an exact half rounded at full size and
//   the kernel sat 2.5 float32 roundings of sum |F G| from a float64 sum
//   (the FP32 FMA kernel it replaced 1.3) and failed the 5e-4 dB gate
//   against rfft on noise. So the exact kernel sweeps K twice per half: hm,
//   mh, hl, lh, mm first, while g is ~2^-8 of its size, then hh; only 32
//   wgmmas round at full size. The hh sweep copies and splits hi pieces
//   only. tolerance_db (ops/mel.py) holds each precision to its plain
//   version on that scale, from readings on the H100 (PERF.md). A fresh
//   accumulator per stage added in FP32 was the alternative, at n128
//   quarters of g (frames split four times).
// - int16 input, above: bitwise by construction, checked on the card.
// What is left between the fast kernel and its bound: one block per SM
// (213 KB of shared memory), so the ~200 blocks of the serving shapes take
// two rounds of 132 SMs, the second about half full; and ptxas serializes
// the wgmmas (see the mel product below).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 512;   // frame length (K of the DFT product)
constexpr int LANES = 512;   // packed [Re | Im] DFT columns
constexpr int N_MELS = 64;
constexpr float DB_SCALE = 4.342944819032518f;  // 10 / ln(10)
constexpr float AMIN = 1e-10f;
constexpr int BM = 128;                       // frame rows per block
constexpr int HALF = 256;                     // DFT columns per accumulator pass
constexpr int HALVES = LANES / HALF;          // 2
constexpr int THREADS = 384;                  // warpgroups 0, 1 consume; 2 produces
constexpr int FB_BYTES = N_MELS * HALF * 2;   // a filterbank half, hi or lo: 32768
constexpr int SBO = 128;                      // next 8 rows (every operand)
constexpr int A_LBO = 64 / 8 * 128;           // next 8 K: frames tile (64 rows)
constexpr int G_LBO = HALF / 8 * 128;         // next 8 K: G tile (256 columns)
constexpr int FB_LBO = N_MELS / 8 * 128;      // next 8 K: filterbank half (64 mels)
// registers a thread after setmaxnreg: the block starts at 65536 / 384 -> 168
// a thread, the producer gives up what the consumers take
constexpr int PRODUCER_REGS = 88;
constexpr int CONSUMER_REGS = 208;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168,
              "setmaxnreg asks for more registers than the block holds");

// Ring geometry of each precision, keyed on the DFT's bf16 passes.
template <int PASSES>
struct Ring {
    static_assert(PASSES == 3 || PASSES == 6, "fast runs 3 DFT passes, exact 6");
    static constexpr int NP = PASSES == 6 ? 3 : 2;      // bf16 pieces of each DFT operand
    static constexpr int BK = PASSES == 6 ? 16 : 32;    // K depth of a stage
    static constexpr int STAGES = PASSES == 6 ? 4 : 3;
    static constexpr int KSTEPS = N_FFT / BK;
    // sweeps over K per half: exact runs its five lower-order products over
    // all of K first, then hh (see the consumer)
    static constexpr int SWEEPS = PASSES == 6 ? 2 : 1;
    static constexpr int HALF_STEPS = SWEEPS * KSTEPS;
    static constexpr int STEPS = HALVES * HALF_STEPS;
    static constexpr int A_BYTES = 64 * BK * 2;         // a warpgroup's frames, one piece
    static constexpr int G_BYTES = HALF * BK * 2;       // a G tile, one piece
    static constexpr int STAGE_BYTES = NP * (2 * A_BYTES + G_BYTES);  // fast 49152, exact 36864
    static constexpr int FB_OFF = STAGES * STAGE_BYTES;               // 147456 both
    static constexpr int BAR_OFF = FB_OFF + 2 * FB_BYTES;
    static constexpr int SMEM_BYTES = BAR_OFF + 8 * (2 * STAGES + 2);  // fast 213056, exact 213072
    static_assert(SMEM_BYTES <= 232448, "the kernel exceeds the 227 KB of shared memory");
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: no swizzle, base offset 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(SBO >> 4) << 32;
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

// (a, b) -> NP bf16x2 words, low half = a: each word the round-to-nearest-
// even of what the earlier words leave (every subtraction exact in float32),
// exactly as the host's _bf16_split (NP 2) and _bf16_split3 (NP 3).
template <int NP>
__device__ __forceinline__ void split(float a, float b, uint32_t (&w)[NP]) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        w[q] = *reinterpret_cast<const uint32_t*>(&h);
        a -= __low2float(h);
        b -= __high2float(h);
    }
}

// One K step of one frame row as loaded: BK samples in the input type's bits.
template <typename T, int BK>
struct RawStep {
    uint32_t w[BK * sizeof(T) / 4];
};

// The BK samples at src[k] (zeros for a row past the end): 16-byte loads
// where the row is aligned, else one load a sample.
template <typename T, int BK>
__device__ __forceinline__ void load_step(const T* src, bool vec, int k, RawStep<T, BK>& r) {
    constexpr int W = BK * sizeof(T) / 4;
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

template <int BK>
__device__ __forceinline__ float sample(const RawStep<int16_t, BK>& r, int e) {
    return static_cast<float>(static_cast<int16_t>(r.w[e / 2] >> (16 * (e % 2))));
}

template <int BK>
__device__ __forceinline__ float sample(const RawStep<float, BK>& r, int e) {
    return __uint_as_float(r.w[e]);
}

// gpack: G's NP bf16 pieces pre-packed per step t = half * KSTEPS + kstep
// as [hi | lo] (fast) or [hi | mid | lo] (exact) tiles, each 256 columns x
// BK K in K-major core-matrix order. fbpack: the filterbank per half as
// [hi | lo], each 64 mels x 256 columns in the same order (2 x 32 KB).
// ops/mel.py:pack_operands builds both.
template <typename T, bool TRANSPOSED, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
mel_kernel(const T* __restrict__ wav, const __nv_bfloat16* __restrict__ gpack,
           const __nv_bfloat16* __restrict__ fbpack, float* __restrict__ out,
           int B, int pitch, int n_frames, int hop) {
    using R = Ring<PASSES>;
    constexpr int NP = R::NP, BK = R::BK, STAGES = R::STAGES, KSTEPS = R::KSTEPS;
    constexpr int HALF_STEPS = R::HALF_STEPS;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sbase = smem_addr(smem);
    const uint32_t full = sbase + R::BAR_OFF;      // full[s] at full + 8 s
    const uint32_t empty = full + 8 * STAGES;      // empty[s] at empty + 8 s
    const uint32_t fb_full = empty + 8 * STAGES;
    const uint32_t fb_empty = fb_full + 8;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 128 + 1);  // producer threads + the bulk copy's arrive
            mbar_init(empty + 8 * s, 8);       // consumer warps
        }
        mbar_init(fb_full, 1);
        mbar_init(fb_empty, 8);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const long rows = static_cast<long>(B) * n_frames;
    const long row0 = static_cast<long>(blockIdx.x) * BM;
    const int wg = tid / 128;

    if (wg == 2) {
        // ---- producer: G/filterbank bulk copies, frames split into pieces
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS) : "memory");
        const int pr = tid - 256;  // the tile row whose frames this thread writes
        const long r = row0 + pr;
        const T* src = nullptr;
        if (r < rows) {
            int b, p;
            row_coords<TRANSPOSED>(r, B, n_frames, b, p);
            src = wav + static_cast<long>(b) * pitch + static_cast<long>(p) * hop;
        }
        const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
        // this row's 16-byte slot in its warpgroup's first frames piece
        const uint32_t a_off = (pr / 64) * NP * R::A_BYTES + ((pr % 64) / 8) * SBO + (pr % 8) * 16;
        // Frame samples are loaded one step ahead, so their latency overlaps
        // the wait for a free stage instead of following it.
        RawStep<T, BK> raw;
        load_step(src, vec, 0, raw);
        for (int t = 0; t < R::STEPS; ++t) {
            const int half = t / HALF_STEPS, s = t % HALF_STEPS, ks = s % KSTEPS;
            const int st = t % STAGES;
            const int np = s < KSTEPS ? NP : 1;  // the exact kernel's hh sweep needs hi only
            uint32_t w[NP][BK / 2];
#pragma unroll
            for (int j = 0; j < BK / 2; ++j) {
                uint32_t pc[NP];
                split<NP>(sample(raw, 2 * j), sample(raw, 2 * j + 1), pc);
#pragma unroll
                for (int q = 0; q < NP; ++q) w[q][j] = pc[q];
            }
            if (t + 1 < R::STEPS) load_step(src, vec, (ks + 1) % KSTEPS * BK, raw);
            mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
            const uint32_t stage = sbase + st * R::STAGE_BYTES;
            if (tid == 256) {
                const long tile = static_cast<long>(half) * KSTEPS + ks;
                mbar_arrive_tx(full + 8 * st, np * R::G_BYTES);
                bulk_load(stage + 2 * NP * R::A_BYTES, gpack + tile * NP * R::G_BYTES / 2,
                          np * R::G_BYTES, full + 8 * st);
            }
#pragma unroll
            for (int c = 0; c < BK / 8; ++c) {
                const uint32_t dst = stage + a_off + c * A_LBO;
#pragma unroll
                for (int q = 0; q < NP; ++q)
                    if (q < np)
                        st_shared_v4(dst + q * R::A_BYTES, make_uint4(w[q][4 * c], w[q][4 * c + 1],
                                                                      w[q][4 * c + 2], w[q][4 * c + 3]));
            }
            // the frames were written by the generic proxy; wgmma reads
            // through the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full + 8 * st);
            if (s == STAGES - 1 && tid == 256) {
                // the half's filterbank, once the ring is full; for the
                // second half this waits for the first half's mel product
                mbar_wait(fb_empty, (half & 1) ^ 1);
                mbar_arrive_tx(fb_full, 2 * FB_BYTES);
                bulk_load(sbase + R::FB_OFF, fbpack + half * FB_BYTES, 2 * FB_BYTES, fb_full);
            }
        }
    } else {
        // ---- consumers: 64 rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS) : "memory");
        const int warp = (tid % 128) / 32, lane = tid % 32;
        float g[128];
        float mel[32];
#pragma unroll
        for (int i = 0; i < 128; ++i) g[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) mel[i] = 0.f;
        for (int half = 0; half < HALVES; ++half) {
            for (int s = 0; s < HALF_STEPS; ++s) {
                const int t = half * HALF_STEPS + s, ks = s % KSTEPS, st = t % STAGES;
                mbar_wait(full + 8 * st, (t / STAGES) & 1);
                const uint32_t a0 = sbase + st * R::STAGE_BYTES + wg * NP * R::A_BYTES;
                const uint32_t b0 = sbase + st * R::STAGE_BYTES + 2 * NP * R::A_BYTES;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
                    uint64_t a[NP], b[NP];  // frames and G pieces: hi, (mid,) lo
#pragma unroll
                    for (int q = 0; q < NP; ++q) {
                        a[q] = smem_desc(a0 + q * R::A_BYTES + kk * 2 * A_LBO, A_LBO);
                        b[q] = smem_desc(b0 + q * R::G_BYTES + kk * 2 * G_LBO, G_LBO);
                    }
                    // the products in one fixed order, frames piece x G
                    // piece; the half's first product overwrites g.
                    // fast: hh, hl, lh per k16.
                    // exact: hm, mh, hl, lh, mm per k16 over all of K, then
                    // hh over all of K. wgmma rounds each f32 sum at the
                    // accumulator's magnitude, so the five small products
                    // go in while g is still ~2^-8 of its size and only
                    // the 32 hh products round at full size (192 with hh
                    // first in every k16: 2.5 float32 roundings of sum
                    // |F G| from a float64 sum on the H100, PERF.md)
                    if constexpr (NP == 2) {
                        wgmma_256_ss(g, a[0], b[0], ks | kk);
                        wgmma_256_ss(g, a[0], b[1], 1);
                        wgmma_256_ss(g, a[1], b[0], 1);
                    } else if (s < KSTEPS) {
                        wgmma_256_ss(g, a[0], b[1], ks | kk);
                        wgmma_256_ss(g, a[1], b[0], 1);
                        wgmma_256_ss(g, a[0], b[2], 1);
                        wgmma_256_ss(g, a[2], b[0], 1);
                        wgmma_256_ss(g, a[1], b[1], 1);
                    } else {
                        wgmma_256_ss(g, a[0], b[0], 1);
                    }
                }
                wgmma_commit();
                wgmma_wait<1>();  // the previous step's products are done: free its stage
                if (s > 0 && lane == 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
            }
            wgmma_wait<0>();
            keep(g);
            if (lane == 0) mbar_arrive(empty + 8 * ((half * HALF_STEPS + HALF_STEPS - 1) % STAGES));
            // power = g^2, split into bf16 hi/lo in registers, one k16 slice
            // at a time: accumulator elements 8s..8s+7 are, pairwise, the A
            // fragment of the half's columns 16s..16s+15
            mbar_wait(fb_full, half & 1);
#pragma unroll
            for (int s = 0; s < HALF / 16; ++s) {
                uint32_t a_h[4], a_l[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float x0 = g[8 * s + 2 * i], x1 = g[8 * s + 2 * i + 1];
                    uint32_t pc[2];
                    split<2>(x0 * x0, x1 * x1, pc);
                    a_h[i] = pc[0];
                    a_l[i] = pc[1];
                }
                const uint64_t fh = smem_desc(sbase + R::FB_OFF + s * 2 * FB_LBO, FB_LBO);
                const uint64_t fl = smem_desc(sbase + R::FB_OFF + FB_BYTES + s * 2 * FB_LBO, FB_LBO);
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

template <typename T, bool TRANSPOSED, int PASSES>
int launch(const void* wav, const void* g, const void* fb, float* out, int B, int pitch,
           int n_frames, int hop, cudaStream_t stream) {
    constexpr int smem = Ring<PASSES>::SMEM_BYTES;
    // above 48 KB of dynamic shared memory only once allowed, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        mel_kernel<T, TRANSPOSED, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long rows = static_cast<long>(B) * n_frames;
    const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM));
    mel_kernel<T, TRANSPOSED, PASSES><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(wav), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(fb), out, B, pitch, n_frames, hop);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TRANSPOSED>
int launch(bool fast, const void* wav, const void* g, const void* fb, float* out, int B,
           int pitch, int n_frames, int hop, cudaStream_t stream) {
    return fast ? launch<T, TRANSPOSED, 3>(wav, g, fb, out, B, pitch, n_frames, hop, stream)
                : launch<T, TRANSPOSED, 6>(wav, g, fb, out, B, pitch, n_frames, hop, stream);
}

}  // namespace

// wav:   reflect-padded rows, float32 or int16, `pitch` elements apart.
// g, fb: G's bf16 pieces (fast: hi/lo; exact: hi/mid/lo) and the
//        filterbank's hi/lo, pre-packed as mel_kernel reads them
//        (ops/mel.py:pack_operands).
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

// Dynamic shared memory of one block of the fast (fast != 0) or exact kernel, in bytes.
extern "C" int uit_mel_smem_bytes(int fast) {
    return fast ? Ring<3>::SMEM_BYTES : Ring<6>::SMEM_BYTES;
}
