// Persistent autoregressive WaveNet sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/wavenet_pallas.py:pallas_generate (body
// make_generate_kernel) of the JAX package, with both of its sampling heads
// and both of its weight types, at any width it is built for.  It computes
// the same function (front causal conv, L gated dilated layers reading
// their history at ring slot t mod d, the skip product, relu -> post1 ->
// relu -> post2, then the head; teacher-forced priming for t < prime_len,
// window shift), but not K1's algebraically fused residual chain, which was
// tuned for the TPU's matrix-unit turnaround: this kernel runs the unfused
// math on its own packed layout (ops/wavenet_gen.py:pack_params).
//
// Heads.  Scalar input ('raw', 'mulaw'): a W-sample window feeds a [W, R]
// front conv and the mixture-of-logistics head samples the next value.
// Quantized input ('mulaw-quantize'): the window holds W class ids (-1 for
// "no sample yet", which selects nothing), the one-hot front conv is a
// gather of W rows of front_oh [W, Q, R], and the Q-way softmax head draws
// a class: scores log(softmax + 1e-20) / temperature, Gumbel-max noise,
// the lowest class among tied maxima.  The output is the class id as f32.
//
// Weights.  The kernel body is templated on the weight type (float or
// __nv_bfloat16).  bf16 weights are widened to f32 in registers; each
// activation is rounded to bf16 before its product and every sum is f32,
// the numeric contract of the Pallas kernel's bf16 path (activation cast to
// the weight type, f32 accumulation).  Biases, the lc projection, the ring
// histories and h stay f32.
//
// Widths.  Any L, R, D, S, front taps W, MoL components and softmax classes
// whose layout fits a block's shared memory, or, with the gate channels
// split, the shared memory of a cluster of up to 8 blocks.  The kernel
// works on R, D and S padded to multiples of 8 (D to a multiple of 8k when
// it is split over k blocks), so every weight row is a whole number of
// 16-byte chunks in either weight type.  The wrapper zero-pads the weights
// (ops/wavenet_gen.py:kernel_layout), which is exact: a padded gate channel
// has zero weights and no lc term, so it gates tanh(0) * sigmoid(0) = 0; a
// padded residual row stays 0; a padded skip column gives relu(0) = 0 into
// zero post rows.  The lc projection keeps the caller's D, and the kernel
// stages each row into the padded layout.  Three instances per weight type:
// R = D = 32 with the full weight ring (wn_moon's widths, the chain's
// loops unrolled at compile time and h[r] in a register), any other width
// that fits one block, read at run time, and the cluster instance below.
//
// Cluster instance (widths over one block's shared memory, e.g. R = D =
// 128 at 50 layers).  Each stream runs on a thread-block cluster of k = 2,
// 4 or 8 blocks (plan below, mirrored by ops/wavenet_gen.py:kernel_plan);
// block c owns gate channels [c D/k, (c+1) D/k).
// Its producer streams only its slice of each layer's tap rows and
// residual columns (w_res_t repacked [L, k, R, D/k] by the wrapper) into
// its own ring; its chain warp computes its D/k gated values and, from
// them, partial residual sums for all R rows, which it stores into slot c
// of every block's exchange buffer through distributed shared memory
// (st.async, each store completing its bytes on that block's layer
// mbarrier: a release-arrive per peer cost a fence each, and grew the
// step with k).  Each
// block then adds b_res and the k partials in the fixed order c = 0..k-1,
// so all k copies of h stay bit-identical; two exchange buffers, by layer
// parity, keep layer l + 2's stores off layer l's values (a block sends
// layer l + 1 only after it has read layer l).  Every block keeps its own
// copy of the stream's ring histories in global scratch, so no block reads
// another's global writes.  The skip warps of each block take their D/k
// rows of each layer (w_skip repacked [k, L D/k, S]); after a cluster
// barrier block 0 sums the k partial skip vectors through distributed
// shared memory, runs relu -> post1 -> post2 -> head alone (only it draws
// noise, from today's Philox subsequences) and stores the sample into
// every block's shared memory before the next cluster barrier.
//
// Design.  One thread block of 16 warps per stream (B <= 8 in practice),
// persistent: it loops over all T samples itself, because blocks run in no
// order and nothing carries over between them.  A step stages its history
// rows and lc row and runs the front conv; then three roles run at once,
// with no block-wide barrier until all L layers are done:
// - the chain warp (warp 0) runs the L gated layers alone: lane j owns
//   gate channels j, j + 32, ... (their filter and gate rows over the 2R
//   inputs, tanh * sigmoid in its own registers); after a __syncwarp lane r
//   takes the D gated values from shared memory for its residual rows r,
//   r + 32, ...  Every lane arrives on the layer's mbarrier, one without a
//   channel too.  Lanes read their weight rows at a rotated chunk order, so
//   the 16-byte shared loads of a quarter-warp fall in distinct banks;
// - one producer thread (warp 1) keeps a ring of NSLOT layer slots in
//   shared memory filled with each layer's tap and residual weights by
//   Hopper's bulk async copy (cp.async.bulk, completed on a "full"
//   mbarrier; the chain frees a slot on its "empty" mbarrier).  The ring
//   wraps across steps, so the next step's first layers load during this
//   step's tail.  NSLOT is as many slots as fit, up to 8 (bf16) or 4 (f32);
//   a single slot is enough to be correct;
// - the skip warps (all but warp 0, warp 1 and the other warps of warp 0's
//   scheduler) accumulate the skip product from each layer's gated output
//   as the chain publishes it (one mbarrier per layer), in partial sums.
// A block-wide barrier then hands the skip sums to relu, post1, post2 and
// the head.  Shared memory holds the weight ring (NSLOT slots of 5RD
// weights: 80 KB at wn_moon's widths), the window, h, the history rows, lc
// row, gated outputs, skip/post buffers, logits and partial sums (L(3R +
// 3D) + 2R + 2S + C + W + 4096 floats: about 55 KB for wn_moon).
// smem_layout computes it; widths whose layout exceeds the 232,448 bytes a
// block may use even with one slot take the cluster instance, and those
// that exceed it even split over 8 blocks are refused (wavenet_gen_plan
// and wavenet_gen_smem_bytes report the bytes, ops/wavenet_gen.py mirrors
// them).  Activations are
// rounded to the weight type once, where they are stored.  The ring
// histories (sum(d)*R f32 per stream, ~655 KB for wn_moon) live in a
// zeroed global scratch; the weights (~5.4 MB in f32 for wn_moon, half
// that in bf16; the softmax head adds a [256, 512] post2) stay resident in
// the 50 MB L2.
//
// What bounds it on this card: the chain is a serial latency chain of L =
// 50 dependent layers, one warp's instruction latency per layer (its
// shared loads, multiply-adds, tanh and exp, two __syncwarp), ~0.5 us a
// layer on an H100 at R = D = 32, and it grows with R * D / 32 per lane;
// and the skip product's weights (1.6 MB a step in bf16, 3.2 MB in f32, for
// wn_moon) stream from L2 into one SM, at a rate set by the loads each
// skip thread keeps in flight.  The two share the SM's memory pipe: run
// together they take longer than either alone.  The card's arithmetic and
// memory rates are far from the limit.  Later versions would split each
// stream's weights across a thread-block cluster's shared memory (which
// also lifts the width ceiling), serve all streams from one weight read,
// and use warp-level MMA.  The cluster instance does the first of these
// for widths past one block; at R = D = 128 each block then streams 1/k
// of the layer weights, and the chain pays one exchange round trip per
// layer.
//
// Noise: counter-based Philox (curand_kernel.h), seeded by the wrapper from
// a torch.Generator, one subsequence per (stream, lane) of warp 0; or, for
// tests, a noise tensor of uniforms ([T, B, nr_mix+1] for MoL, [T, B, Q]
// for the softmax head) that replaces it.  Uniforms are clipped to
// [1e-5, 1-1e-5].  Tied maxima of the MoL head are averaged, as K1 does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FW = 32;     // R = D of the specialised instance
constexpr int NT = 512;    // threads: 16 warps
constexpr int PRODUCER = 32;  // the thread that issues the weight copies
// Skip warps: every warp but the chain warp, the producer's and the other
// warps of the chain warp's scheduler (warp w issues on scheduler w mod 4),
// so the chain has its scheduler to itself.
constexpr int NSK = 32 * (NT / 32 - NT / 128 - 1);
constexpr int MAX_S = 8 * NT;  // skip channels: the partial sums' buffer
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (H100)
constexpr int MAX_CLUSTER = 8;      // blocks per stream (the portable most)
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr float U_MIN = 1e-5f;
constexpr float U_MAX = 1.0f - 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

// The most layer slots of the weight ring (80 KB of shared memory either
// way at R = D = 32).
template <typename WT>
__host__ __device__ constexpr int nslot() { return sizeof(WT) == 2 ? 8 : 4; }
__host__ __device__ constexpr int max_slots(int wsize) {
  return wsize == 2 ? 8 : 4;
}
// The kernel's widths: R, D and S padded to whole 16-byte chunks.
__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
// D padded for a split over k blocks: each block's slice a multiple of 8.
__host__ __device__ constexpr int pad_split(int n, int k) {
  return (n + 8 * k - 1) / (8 * k) * (8 * k);
}

// Byte offsets into the dynamic shared memory: the weight ring, its
// mbarriers, the f32 buffers, the int tables.  R, D and S are the padded
// widths (D is a block's share of the gate channels when the stream is
// split over a cluster of k > 1 blocks, which adds L exchange mbarriers,
// the two exchange buffers [2][k][R], the partial skip vector [S] and the
// sample's slot), so every f32 buffer starts 16-byte aligned.
struct Smem {
  unsigned bars, f32s, ints, total;
};
__host__ __device__ inline Smem smem_layout(int L, int R, int D, int S,
                                            int C, int W, int nslot,
                                            int wsize, int k = 1) {
  Smem m;
  m.bars = (unsigned)(nslot * 5 * R * D * wsize);
  m.f32s = (m.bars + 8u * (2 * nslot + L + (k > 1 ? L : 0)) + 15u) & ~15u;
  const unsigned floats = up4(W) + 2 * R + L * R + L * 2 * D + L * D +
                          2 * S + up4(C) + L * R + 8 * NT +
                          (k > 1 ? 2 * k * R + S + 4 : 0);
  m.ints = m.f32s + 4u * floats;
  m.total = m.ints + 4u * 3 * L;
  return m;
}

// The most weight slots whose layout fits a block (padded widths, D a
// block's share when k > 1), or 0 when not even one does.
inline int fit_slots(int L, int R, int D, int S, int C, int W, int wsize,
                     int k = 1) {
  for (int n = max_slots(wsize); n >= 1; --n)
    if (smem_layout(L, R, D, S, C, W, n, wsize, k).total <=
        (unsigned)SMEM_LIMIT)
      return n;
  return 0;
}

// The plan at the caller's widths: blocks per stream, the weight slots and
// the shared memory bytes per block.  One block whenever its layout fits;
// else, of the cluster sizes 2, 4 and 8 whose layout fits, the fewest that
// leave each chain lane at most one gate channel (D/k <= 32), or the fewest
// when none does (at R = D = 128 the chain's per-lane work, not the
// weights' room, sets the step: bf16 ran 340.7 us at 2 blocks against
// 245.7 at 4 on an H100); 8 blocks with 0 slots (and the one-slot bytes)
// when none fits.
inline int plan(int L, int R, int D, int S, int C, int W, int wsize,
                int* blocks, int* slots) {
  int best = 0, best_n = 0;
  unsigned total = 0;
  for (int k = 1; k <= MAX_CLUSTER; k *= 2) {
    const int Dl = pad_split(D, k) / k;
    const int n = fit_slots(L, pad8(R), Dl, pad8(S), C, W, wsize, k);
    if (n > 0 && (best == 0 || (best > 1 && pad_split(D, best) / best > 32 &&
                                Dl <= 32))) {
      best = k;
      best_n = n;
      total = smem_layout(L, pad8(R), Dl, pad8(S), C, W, n, wsize, k).total;
    }
    if (best == 1) break;
  }
  if (best == 0) {
    best = MAX_CLUSTER;
    total = smem_layout(L, pad8(R), pad_split(D, best) / best, pad8(S), C, W,
                        1, wsize, best).total;
  }
  *blocks = best;
  *slots = best_n;
  return (int)total;
}

// R, D and S are the padded widths; lc_proj keeps the caller's D (Dlc).
// With k > 1 blocks per stream, w_res_t is [L, k, R, D/k] and w_skip
// [k, L*D/k, S].
struct Params {
  const float* lc_proj;    // [B, T, L*2Dlc] per layer [filter Dlc | gate Dlc]
  const void* w_tap;       // [L, 2D, 2R]    row 2j+f, cols [old tap | cur tap]
  const void* w_res_t;     // [L, R, D]
  const float* b_res;      // [L, R]
  const void* front;       // scalar: [R, W]; quantized: [W, Q, R]
  const void* w_skip;      // [L*D, S]
  const float* skip_bias;  // [S]
  const void* post1;       // [S, S]
  const float* b1;         // [S]
  const void* post2_t;     // [C, S]
  const float* b2;         // [C]
  const int* dil;          // [L]
  const float* primed;     // [T, B] or null (samples, or class ids)
  const float* noise;      // [T, B, nr+1] (MoL) / [T, B, C] (softmax) or null
  float* ring;             // [B, k, ring_stride] zeroed
  float* out;              // [B, T]
  unsigned long long seed;
  long long ring_stride;
  int B, T, L, R, D, Dlc, W, S, C, prime_len, deterministic, quantized;
  int nslot;
  float temperature;
  int k;                   // blocks per stream (the cluster instance's)
};

// Weight loads, widened to f32, and the rounding of an activation to the
// weight type before its product.
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

template <typename WT> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[v] += x * (the V weights in the 16 bytes u), in column order.
template <typename WT>
__device__ __forceinline__ void fma_row(float x, const uint4 u, float* acc) {
  if constexpr (sizeof(WT) == 2) {
    acc[0] += x * bf16_lo(u.x); acc[1] += x * bf16_hi(u.x);
    acc[2] += x * bf16_lo(u.y); acc[3] += x * bf16_hi(u.y);
    acc[4] += x * bf16_lo(u.z); acc[5] += x * bf16_hi(u.z);
    acc[6] += x * bf16_lo(u.w); acc[7] += x * bf16_hi(u.w);
  } else {
    acc[0] += x * __uint_as_float(u.x); acc[1] += x * __uint_as_float(u.y);
    acc[2] += x * __uint_as_float(u.z); acc[3] += x * __uint_as_float(u.w);
  }
}

// mbarriers and the 1-D bulk copy (PTX; shared::cluster addresses of a
// block launched without a cluster are its own shared::cta addresses).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile("{\n .reg .pred p;\n"
               " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

// Distributed shared memory of a cluster: the shared::cluster address of
// this block's shared::cta address `a` in the block of rank `rank`, f32
// stores and loads there, an asynchronous store that completes its 4 bytes
// on a peer's mbarrier (no fence: the peer's phase completes when all the
// bytes it expects have landed), an acquire wait (cluster scope) on this
// block's own mbarrier, and the cluster-wide barrier.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(a), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_async(uint32_t a, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
               " [%0], %1, [%2];\n"
               :: "r"(a), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
                 " p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One 16-byte chunk of weights in shared memory (4 f32 or 8 bf16) against
// the activations x (f32, already rounded), multiply-added into four
// accumulators: `two` does a filter and a gate row at once.
template <typename WT> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void one(const float* w, const float* x,
                                             float* a) {
    const float4 u = *reinterpret_cast<const float4*>(w);
    const float4 v = *reinterpret_cast<const float4*>(x);
    a[0] += v.x * u.x; a[1] += v.y * u.y; a[2] += v.z * u.z; a[3] += v.w * u.w;
  }
  __device__ static __forceinline__ void two(const float* wf, const float* wg,
                                             const float* x, float* af,
                                             float* ag) {
    const float4 u = *reinterpret_cast<const float4*>(wf);
    const float4 q = *reinterpret_cast<const float4*>(wg);
    const float4 v = *reinterpret_cast<const float4*>(x);
    af[0] += v.x * u.x; af[1] += v.y * u.y; af[2] += v.z * u.z; af[3] += v.w * u.w;
    ag[0] += v.x * q.x; ag[1] += v.y * q.y; ag[2] += v.z * q.z; ag[3] += v.w * q.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void fma8(const uint4 u, const float4 v0,
                                              const float4 v1, float* a) {
    a[0] += v0.x * bf16_lo(u.x); a[1] += v0.y * bf16_hi(u.x);
    a[2] += v0.z * bf16_lo(u.y); a[3] += v0.w * bf16_hi(u.y);
    a[0] += v1.x * bf16_lo(u.z); a[1] += v1.y * bf16_hi(u.z);
    a[2] += v1.z * bf16_lo(u.w); a[3] += v1.w * bf16_hi(u.w);
  }
  __device__ static __forceinline__ void one(const __nv_bfloat16* w,
                                             const float* x, float* a) {
    const uint4 u = *reinterpret_cast<const uint4*>(w);
    const float4 v0 = *reinterpret_cast<const float4*>(x);
    const float4 v1 = *reinterpret_cast<const float4*>(x + 4);
    fma8(u, v0, v1, a);
  }
  __device__ static __forceinline__ void two(const __nv_bfloat16* wf,
                                             const __nv_bfloat16* wg,
                                             const float* x, float* af,
                                             float* ag) {
    const uint4 u = *reinterpret_cast<const uint4*>(wf);
    const uint4 q = *reinterpret_cast<const uint4*>(wg);
    const float4 v0 = *reinterpret_cast<const float4*>(x);
    const float4 v1 = *reinterpret_cast<const float4*>(x + 4);
    fma8(u, v0, v1, af);
    fma8(q, v0, v1, ag);
  }
};

__device__ __forceinline__ float sum4(const float* a) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

__device__ __forceinline__ float clip_u(float u) {
  return fminf(fmaxf(u, U_MIN), U_MAX);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// y[s] = relu(sum_k x[k] * M[k, s] + bias[s]), rounded to the weight type,
// for M [K, S] row-major and x already rounded; ends with a barrier.  This
// stream of weights from L2 into one SM is bounded by the bytes each thread
// keeps in flight, and the two weight types take the loop that measured
// fastest for them on an H100: f32 one column per thread, four rows
// per iteration (neighbouring threads read neighbouring words); bf16 eight
// columns per thread with one 16-byte load per row, eight rows loaded
// before use, over one of H = NT / (S/8) chunks of the rows, the H partial
// sums (in `part`, [8 * NT]) added after a barrier.  K and S are multiples
// of 8.
template <typename WT>
__device__ __forceinline__ void dense_relu(const float* x, const WT* M,
                                           const float* bias, int K, int S,
                                           float* y, float* part, int tid) {
  if constexpr (sizeof(WT) == 4) {
    for (int s = tid; s < S; s += NT) {
      const WT* wc = M + s;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int k = 0; k < K; k += 4) {
        a0 += x[k] * ldw(wc + (long long)k * S);
        a1 += x[k + 1] * ldw(wc + (long long)(k + 1) * S);
        a2 += x[k + 2] * ldw(wc + (long long)(k + 2) * S);
        a3 += x[k + 3] * ldw(wc + (long long)(k + 3) * S);
      }
      y[s] = fmaxf((a0 + a1) + (a2 + a3) + bias[s], 0.f);
    }
    __syncthreads();
  } else {
    constexpr int U = 8;
    const int P = S / 8, H = NT / P;
    if (tid < H * P) {
      const int c = tid % P, h = tid / P;
      const int chunk = (K + H - 1) / H;
      const int k1 = min(K, (h + 1) * chunk);
      const WT* col = M + 8 * c;
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      int k = h * chunk;
      for (; k + U <= k1; k += U) {
        uint4 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          w[u] = __ldg(reinterpret_cast<const uint4*>(col + (long long)(k + u) * S));
#pragma unroll
        for (int u = 0; u < U; ++u) fma_row<WT>(x[k + u], w[u], acc);
      }
      for (; k < k1; ++k)
        fma_row<WT>(x[k],
                    __ldg(reinterpret_cast<const uint4*>(col + (long long)k * S)),
                    acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) part[h * S + 8 * c + i] = acc[i];
    }
    __syncthreads();
    for (int s = tid; s < S; s += NT) {
      float v = 0.f;
      for (int j = 0; j < H; ++j) v += part[j * S + s];
      y[s] = rnd<WT>(fmaxf(v + bias[s], 0.f));
    }
    __syncthreads();
  }
}

// Mixture-of-logistics head, by warp 0: Gumbel-max component, then the
// logistic inverse CDF, clipped to [-1, 1].  Lane takes components lane +
// 32k, keeping its best score and the count, summed means and summed log
// scales of its components tied at it; the lanes at the warp's maximum
// pool theirs, so tied maxima share the weight.  Philox: each lane draws
// one uniform per component, then lane 0 the logistic draw.
__device__ float mol_head(const Params& p, const float* logits, int t, int b,
                          int lane, curandStatePhilox4_32_10_t* rng) {
  const int nr = p.C / 3;
  const float* nz =
      (!p.deterministic && p.noise != nullptr)
          ? p.noise + ((long long)t * p.B + b) * (nr + 1) : nullptr;
  float best = -INFINITY, n = 0.f, mean = 0.f, ls = 0.f;
  for (int c = lane; c < nr; c += 32) {
    float score = logits[c];
    if (!p.deterministic)
      score -= logf(-logf(clip_u(nz ? nz[c] : curand_uniform(rng))));
    if (score > best) {
      best = score; n = 1.f; mean = logits[nr + c]; ls = logits[2 * nr + c];
    } else if (score == best) {
      n += 1.f; mean += logits[nr + c]; ls += logits[2 * nr + c];
    }
  }
  float u = 0.5f;
  if (!p.deterministic) {
    if (nz == nullptr) {
      const float u0 = (lane == 0) ? curand_uniform(rng) : 0.f;
      u = clip_u(__shfl_sync(FULL, u0, 0));
    } else {
      u = clip_u(nz[nr]);
    }
  }
  const bool top = best >= warp_max(best);
  const float cnt = warp_sum(top ? n : 0.f);     // ties share the weight
  const float mu = warp_sum(top ? mean : 0.f) / cnt;
  if (p.deterministic) return fminf(fmaxf(mu, -1.f), 1.f);
  const float s = fmaxf(warp_sum(top ? ls : 0.f) / cnt, LOG_SCALE_MIN);
  const float x = mu + expf(s) * (logf(u) - logf(1.f - u));
  return fminf(fmaxf(x, -1.f), 1.f);
}

// Softmax head, by warp 0: lane handles classes lane + 32k.  Scores
// log(softmax + 1e-20) / temperature (the Pallas kernel's formula), minus
// log(-log(u)) when stochastic; the lowest class among tied maxima wins.
// Philox: each lane draws its classes' uniforms four at a time.
__device__ float softmax_head(const Params& p, const float* logits, int t,
                              int b, int lane,
                              curandStatePhilox4_32_10_t* rng) {
  const int C = p.C;
  float mx = -INFINITY;
  for (int c = lane; c < C; c += 32) mx = fmaxf(mx, logits[c]);
  mx = warp_max(mx);
  float se = 0.f;
  for (int c = lane; c < C; c += 32) se += expf(logits[c] - mx);
  se = warp_sum(se);
  const float* nz =
      p.noise ? p.noise + ((long long)t * p.B + b) * C : nullptr;
  float best = -INFINITY;
  int best_c = C;
  for (int k0 = 0; k0 * 32 < C; k0 += 4) {
    float4 u4 = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    if (!p.deterministic && p.noise == nullptr) u4 = curand_uniform4(rng);
    const float uk[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * (k0 + j);
      if (c >= C) break;
      float s = logf(expf(logits[c] - mx) / se + 1e-20f) / p.temperature;
      if (!p.deterministic) {
        const float u = clip_u(p.noise == nullptr ? uk[j] : nz[c]);
        s -= logf(-logf(u));
      }
      if (s > best) { best = s; best_c = c; }
    }
  }
  for (int o = 16; o; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oc = __shfl_xor_sync(FULL, best_c, o);
    if (ob > best || (ob == best && oc < best_c)) { best = ob; best_c = oc; }
  }
  return (float)best_c;
}

// The skip product's items: V columns each (bf16 eight, f32 four, one
// 16-byte load per row), in H row groups (rows k = h mod H), each group
// with its own partial sums part[h * S + column].
template <typename WT> __host__ __device__ constexpr int skip_cols() {
  return sizeof(WT) == 2 ? 8 : 4;
}
template <typename WT>
__device__ __forceinline__ int skip_groups(int S) {
  return max(1, NSK / (S / skip_cols<WT>()));
}

// The skip warps' share of the skip product, [L*D] @ w_skip [L*D, S], taken
// while the chain runs: they wait for layer l's gated output (ready[l],
// phase `parity`), then take every layer already done at once (a round).
// Item (c, h) multiply-adds rows k = h (mod H) of the round's layers into
// part[h * S + columns of c], U rows loaded before use (bf16 8, f32 16: the
// counts that measured fastest on an H100).  Each column sums its rows in
// order, so the result does not depend on how the layers fell into
// rounds.  `i` is the thread's index among the NSK skip threads.
//
// The skip warps lag the chain and run in bursts.  Variants that kept pace
// with it (the next layer's rows loaded before each wait) made the step
// slower: their steady global loads share the SM's memory pipe with the
// chain warp's shared loads, and the chain is the longer path.
template <typename WT>
__device__ __forceinline__ void skip_partial(const float* gat, const WT* M,
                                             uint64_t* ready,
                                             unsigned parity, int L, int D,
                                             int S, float* part, int i,
                                             int lane) {
  constexpr int V = skip_cols<WT>();
  constexpr int U = sizeof(WT) == 2 ? 8 : 16;
  const int P = S / V, H = skip_groups<WT>(S), n = P * H;
  for (int it = i; it < n; it += NSK) {
    float* pp = part + (it / P) * S + V * (it % P);
#pragma unroll
    for (int v = 0; v < V; ++v) pp[v] = 0.f;
  }
  for (int l0 = 0; l0 < L;) {
    mbar_wait(&ready[l0], parity);
    int l1 = l0 + 1;
    if (lane == 0)
      while (l1 < L && mbar_test(&ready[l1], parity)) ++l1;
    l1 = __shfl_sync(FULL, l1, 0);
    for (int l = l0 + 1; l < l1; ++l) mbar_wait(&ready[l], parity);
    const int k0 = l0 * D, k1 = l1 * D;
    for (int it = i; it < n; it += NSK) {
      const int c = it % P, h = it / P;
      float* pp = part + h * S + V * c;
      const WT* col = M + V * c;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = pp[v];
      int k = k0 + (h - k0 % H + H) % H;   // the first row of group h
      for (; k + (U - 1) * H < k1; k += U * H) {
        uint4 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          w[u] = __ldg(reinterpret_cast<const uint4*>(col + (long long)(k + u * H) * S));
#pragma unroll
        for (int u = 0; u < U; ++u) fma_row<WT>(gat[k + u * H], w[u], acc);
      }
      for (; k < k1; k += H)
        fma_row<WT>(gat[k],
                    __ldg(reinterpret_cast<const uint4*>(col + (long long)k * S)),
                    acc);
#pragma unroll
      for (int v = 0; v < V; ++v) pp[v] = acc[v];
    }
    l0 = l1;
  }
}

// The chain warp's L layers of step t at R = D = 32: lane j owns gate
// channel j and residual row j, and keeps h[j] in a register.  `g` counts
// the layer slots the chain has consumed over the launch (slot g mod NSLOT,
// phase g / NSLOT); layer l's gated output completes phase `parity` of
// ready[l].
template <typename WT>
__device__ __forceinline__ void run_chain(
    const WT* wring, uint64_t* full, uint64_t* empty, uint64_t* ready,
    unsigned parity, const float* h,
    float* hr, const float* olds, const float* lcs, float* gat,
    const float* bres, const int* cur, float* ring, int L, int lane,
    long long& g) {
  constexpr int R = FW, D = FW, TAP = 4 * R * D, RES = R * D;
  constexpr int NSLOT = nslot<WT>();
  constexpr int CH = Chunk<WT>::N;
  constexpr int NK = 2 * R / CH;   // chunks of one tap row
  constexpr int NKR = D / CH;      // chunks of one residual row
  // Rotation of the residual chunks: a bf16 row is 4 chunks long, so lanes
  // r and r + 4 would meet in one bank without the extra shift.
  constexpr int RSH = sizeof(WT) == 2 ? 1 : 0;
  float hv = h[lane];              // h[r], r = lane, f32
  for (int l = 0; l < L; ++l, ++g) {
    const int s = (int)(g % NSLOT);
    mbar_wait(&full[s], (unsigned)((g / NSLOT) & 1));
    const WT* wf = wring + s * (TAP + RES) + (2 * lane) * 2 * R;
    const WT* wg = wf + 2 * R;
    const WT* wr = wring + s * (TAP + RES) + TAP + lane * D;
    // Filter and gate rows of channel j = lane over [old tap | current tap].
    const float* xo = olds + l * R;
    float af[4] = {0.f, 0.f, 0.f, 0.f}, ag[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int k = ((i + lane) & (NK - 1)) * CH;
      Chunk<WT>::two(wf + k, wg + k, k < R ? xo + k : hr + (k - R), af, ag);
    }
    const float f = sum4(af) + lcs[l * 2 * D + lane];
    const float gg = sum4(ag) + lcs[l * 2 * D + D + lane];
    gat[l * D + lane] = rnd<WT>(tanhf(f) * (1.f / (1.f + expf(-gg))));
    mbar_arrive(&ready[l]);   // the skip warps may take layer l
    __syncwarp();
    // Residual: h[r] += b_res[r] + sum_j gated[j] * w_res[j, r].
    float ar[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NKR; ++i) {
      const int k = ((i + (lane >> RSH)) & (NKR - 1)) * CH;
      Chunk<WT>::one(wr + k, gat + l * D + k, ar);
    }
    // This layer's input goes into its ring at slot t mod d.
    ring[cur[l] + lane] = hv;
    hv = hv + (sum4(ar) + bres[l * R + lane]);
    hr[lane] = rnd<WT>(hv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// The chain at any (padded) width: lane owns gate channels j = lane + 32m
// and residual rows r = lane + 32m; h stays in shared memory (f32).  The
// chunk rotation starts each row at its own index modulo the row's chunk
// count.  (slot, phase) is the chain's next layer slot of the ring.
template <typename WT>
__device__ __forceinline__ void run_chain_any(
    const WT* wring, uint64_t* full, uint64_t* empty, uint64_t* ready,
    float* h, float* hr, const float* olds, const float* lcs, float* gat,
    const float* bres, const int* cur, float* ring, int L, int R, int D,
    int nslot, int lane, int& slot, unsigned& phase) {
  constexpr int CH = Chunk<WT>::N;
  const int NK = 2 * R / CH, NKR = D / CH;
  const int TAP = 4 * R * D, RES = R * D;
  for (int l = 0; l < L; ++l) {
    mbar_wait(&full[slot], phase);
    const WT* wl = wring + slot * (TAP + RES);
    const float* xo = olds + l * R;
    for (int j = lane; j < D; j += 32) {
      const WT* wf = wl + (2 * j) * 2 * R;
      const WT* wg = wf + 2 * R;
      float af[4] = {0.f, 0.f, 0.f, 0.f}, ag[4] = {0.f, 0.f, 0.f, 0.f};
      int c = j % NK;
      for (int i = 0; i < NK; ++i) {
        const int k = c * CH;
        Chunk<WT>::two(wf + k, wg + k, k < R ? xo + k : hr + (k - R), af,
                       ag);
        if (++c == NK) c = 0;
      }
      const float f = sum4(af) + lcs[l * 2 * D + j];
      const float gs = sum4(ag) + lcs[l * 2 * D + D + j];
      gat[l * D + j] = rnd<WT>(tanhf(f) * (1.f / (1.f + expf(-gs))));
    }
    mbar_arrive(&ready[l]);   // every lane, with or without a channel
    __syncwarp();
    const WT* wr = wl + TAP;
    for (int r = lane; r < R; r += 32) {
      float ar[4] = {0.f, 0.f, 0.f, 0.f};
      int c = r % NKR;
      for (int i = 0; i < NKR; ++i) {
        const int k = c * CH;
        Chunk<WT>::one(wr + r * D + k, gat + l * D + k, ar);
        if (++c == NKR) c = 0;
      }
      const float hv = h[r];
      ring[cur[l] + r] = hv;   // this layer's input, at slot t mod d
      const float hn = hv + (sum4(ar) + bres[l * R + r]);
      h[r] = hn;
      hr[r] = rnd<WT>(hn);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == nslot) { slot = 0; phase ^= 1; }
  }
}

// The chain of block `rank` of a k-block cluster: its Dl gated channels
// (lane owns j = lane + 32m of them), then partial residual sums over
// those channels for every row r = lane + 32m, stored into slot `rank` of
// every block's exchange buffer xch[l & 1] [k][R]: its own by a plain
// store, each peer's by st.async, whose bytes complete on that peer's
// xbar[l].  Lane 0 arrives once on its own xbar[l], expecting the (k-1) R
// floats of its peers (phase `parity` at step t; a peer's bytes may land
// before this arrive, which the transaction count allows).  After its own
// xbar[l] completes, each block adds the k partials in rank order and b_res
// to h, bit for bit as its peers do.  The weight slot is freed before the
// exchange, so the producer's next copy overlaps it.
template <typename WT>
__device__ __forceinline__ void run_chain_cluster(
    const WT* wring, uint64_t* full, uint64_t* empty, uint64_t* ready,
    uint64_t* xbar, float* xch, unsigned parity, float* h, float* hr,
    const float* olds, const float* lcs, float* gat, const float* bres,
    const int* cur, float* ring, int L, int R, int Dl, int nslot, int k,
    int rank, int lane, int& slot, unsigned& phase) {
  constexpr int CH = Chunk<WT>::N;
  const int NK = 2 * R / CH, NKR = Dl / CH;
  const int TAP = 4 * R * Dl, RES = R * Dl;
  const uint32_t xch_a = smem_addr(xch), xbar_a = smem_addr(xbar);
  for (int l = 0; l < L; ++l) {
    mbar_wait(&full[slot], phase);
    const WT* wl = wring + slot * (TAP + RES);
    const float* xo = olds + l * R;
    for (int j = lane; j < Dl; j += 32) {
      const WT* wf = wl + (2 * j) * 2 * R;
      const WT* wg = wf + 2 * R;
      float af[4] = {0.f, 0.f, 0.f, 0.f}, ag[4] = {0.f, 0.f, 0.f, 0.f};
      int c = j % NK;
      for (int i = 0; i < NK; ++i) {
        const int kk = c * CH;
        Chunk<WT>::two(wf + kk, wg + kk, kk < R ? xo + kk : hr + (kk - R), af,
                       ag);
        if (++c == NK) c = 0;
      }
      const float f = sum4(af) + lcs[l * 2 * Dl + j];
      const float gs = sum4(ag) + lcs[l * 2 * Dl + Dl + j];
      gat[l * Dl + j] = rnd<WT>(tanhf(f) * (1.f / (1.f + expf(-gs))));
    }
    mbar_arrive(&ready[l]);   // every lane, with or without a channel
    __syncwarp();
    const WT* wr = wl + TAP;
    const int mine = ((l & 1) * k + rank) * R;
    const uint32_t bar = xbar_a + 8u * l;
    for (int r = lane; r < R; r += 32) {
      float ar[4] = {0.f, 0.f, 0.f, 0.f};
      int c = r % NKR;
      for (int i = 0; i < NKR; ++i) {
        const int kk = c * CH;
        Chunk<WT>::one(wr + r * Dl + kk, gat + l * Dl + kk, ar);
        if (++c == NKR) c = 0;
      }
      const float part = sum4(ar);
      xch[mine + r] = part;
      for (int q = 0; q < k; ++q)
        if (q != rank)
          st_async(mapa(xch_a + 4u * (mine + r), q), part, mapa(bar, q));
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[slot]);
      mbar_expect_tx(&xbar[l], 4u * (k - 1) * R);
    }
    if (++slot == nslot) { slot = 0; phase ^= 1; }
    mbar_wait_cluster(&xbar[l], parity);
    const float* xl = xch + (l & 1) * k * R;
    for (int r = lane; r < R; r += 32) {
      float s = xl[r];
      for (int q = 1; q < k; ++q) s += xl[q * R + r];
      const float hv = h[r];
      ring[cur[l] + r] = hv;   // this layer's input, at slot t mod d
      const float hn = hv + (s + bres[l * R + r]);
      h[r] = hn;
      hr[r] = rnd<WT>(hn);
    }
    __syncwarp();
  }
}

// Fill ring slot s with layer l's tap and residual weights (tap and res
// weights each).
template <typename WT>
__device__ __forceinline__ void issue_layer(WT* wring, uint64_t* full,
                                            const WT* w_tap,
                                            const WT* w_res_t, int s, int l,
                                            int tap, int res) {
  WT* dst = wring + s * (tap + res);
  mbar_expect_tx(&full[s], (tap + res) * sizeof(WT));
  bulk_copy(dst, w_tap + (long long)l * tap, tap * sizeof(WT), &full[s]);
  bulk_copy(dst + tap, w_res_t + (long long)l * res, res * sizeof(WT),
            &full[s]);
}

// Fill ring slot s with one block's spans of a layer: `tap` weights from
// tap_src, `res` from res_src.
template <typename WT>
__device__ __forceinline__ void load_span(WT* wring, uint64_t* full,
                                           const WT* tap_src,
                                           const WT* res_src, int s, int tap,
                                           int res) {
  WT* dst = wring + s * (tap + res);
  mbar_expect_tx(&full[s], (tap + res) * sizeof(WT));
  bulk_copy(dst, tap_src, tap * sizeof(WT), &full[s]);
  bulk_copy(dst + tap, res_src, res * sizeof(WT), &full[s]);
}

// The producer's next layer slot: ring slot s of phase ph, layer l.
__device__ __forceinline__ void advance(int& s, unsigned& ph, int& l,
                                        int nslot, int L) {
  if (++l == L) l = 0;
  if (++s == nslot) { s = 0; ph ^= 1; }
}

// RF = FW: R = D = 32 with nslot<WT>() slots; RF = 0: the widths and the
// slot count of Params.
template <typename WT, int RF>
__global__ void __launch_bounds__(NT, 1) wavenet_gen_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool FIXED = RF != 0;
  const int NSLOT = FIXED ? nslot<WT>() : p.nslot;
  const int R = FIXED ? RF : p.R, D = FIXED ? RF : p.D;
  const int DL = FIXED ? RF : p.Dlc;     // lc_proj's D
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int L = p.L, W = p.W, S = p.S, C = p.C;
  const int LD2 = L * 2 * D, TAP = 4 * R * D, RES = R * D;
  const WT* w_tap = static_cast<const WT*>(p.w_tap);
  const WT* w_res_t = static_cast<const WT*>(p.w_res_t);
  const WT* front = static_cast<const WT*>(p.front);
  const WT* w_skip = static_cast<const WT*>(p.w_skip);
  const WT* post1 = static_cast<const WT*>(p.post1);
  const WT* post2_t = static_cast<const WT*>(p.post2_t);

  const Smem m = smem_layout(L, R, D, S, C, W, NSLOT, sizeof(WT));
  WT* wring = reinterpret_cast<WT*>(smem_raw);  // [NSLOT][TAP + RES]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + m.bars);
  uint64_t* empty = full + NSLOT;
  uint64_t* ready = empty + NSLOT;   // [L] layer l's gated output stored
  float* win = reinterpret_cast<float*>(smem_raw + m.f32s);  // [W]
  float* h = win + up4(W);           // [R]   f32 layer-0 input
  float* hr = h + R;                 // [R]   the chain's input, rounded
  float* olds = hr + R;              // [L*R] history rows h[t-d] (rounded)
  float* lcs = olds + L * R;         // [L*2D] lc projection row of this step
  float* gat = lcs + LD2;            // [L*D] gated outputs (rounded)
  float* z = gat + L * D;            // [S]
  float* z1 = z + S;                 // [S]
  float* logits = z1 + S;            // [C]
  float* bres = logits + up4(C);     // [L*R] residual biases
  float* part = bres + L * R;        // [8 * NT] partial sums
  int* dil = reinterpret_cast<int*>(smem_raw + m.ints);  // [L]
  int* roff = dil + L;               // [L] ring offset of each layer
  int* cur = roff + L;               // [L] this step's ring row of each layer

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int l = 0; l < L; ++l) mbar_init(&ready[l], 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < W; i += NT) win[i] = p.quantized ? -1.f : 0.f;
  for (int l = tid; l < L; l += NT) dil[l] = p.dil[l];
  for (int i = tid; i < L * R; i += NT) bres[i] = p.b_res[i];
  // Padded gate channels take no lc term: their lc entries stay 0.
  if (DL != D)
    for (int i = tid; i < LD2; i += NT) lcs[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int l = 0; l < L; ++l) { roff[l] = o; o += dil[l] * R; }
  }
  curandStatePhilox4_32_10_t rng;
  const bool philox = !p.deterministic && p.noise == nullptr;
  if (philox && warp == 0)
    curand_init(p.seed, (unsigned long long)b * 32 + lane, 0, &rng);
  float* ring = p.ring + (long long)b * p.ring_stride;
  const int LDL = L * 2 * DL;
  const float* lc_b = p.lc_proj + (long long)b * p.T * LDL;
  // The producer's next layer slot (ring slot ps of phase pph, layer pl)
  // and the count it has issued; the chain's next slot.
  const long long n_slots = (long long)p.T * L;
  const int n_groups = skip_groups<WT>(S);   // the skip's row groups
  long long g_load = 0, g_chain = 0;
  int ps = 0, pl = 0, cs = 0;
  unsigned pph = 0, cph = 0;
  if (tid == PRODUCER)
    for (; g_load < NSLOT && g_load < n_slots; ++g_load) {
      issue_layer(wring, full, w_tap, w_res_t, ps, pl, TAP, RES);
      advance(ps, pph, pl, NSLOT, L);
    }
  __syncthreads();

  const int r16 = tid >> 4, g16 = tid & 15;
  // This thread's index among the skip threads, or -1.
  const int skip_i = (warp > 1 && warp % 4 != 0)
                         ? (warp - warp / 4 - 2) * 32 + lane : -1;

  for (int t = 0; t < p.T; ++t) {
    // Teacher forcing: the window's newest column takes the seed sample.
    if (tid == 0 && t < p.prime_len)
      win[W - 1] = p.primed[(long long)t * p.B + b];
    // Stage every layer's history row (slot t mod d, read before this
    // step's stores) and the lc projection row (into the padded layout).
    for (int i = tid; i < L * R; i += NT) {
      const int l = i / R;
      olds[i] = rnd<WT>(ring[roff[l] + (t % dil[l]) * R + (i % R)]);
    }
    for (int l = tid; l < L; l += NT) cur[l] = roff[l] + (t % dil[l]) * R;
    const float* lrow = lc_b + (long long)t * LDL;
    if (DL == D) {
      for (int i = tid; i < LD2; i += NT) lcs[i] = lrow[i];
    } else {
      for (int i = tid; i < LDL; i += NT) {
        const int q = i / DL;        // (layer, filter or gate)
        lcs[q * D + (i - q * DL)] = lrow[i];
      }
    }
    __syncthreads();

    if (p.quantized) {
      // One-hot front conv: h[r] = sum over the window's classes c_w >= 0
      // of front[w, c_w, r].
      for (int r = tid; r < R; r += NT) {
        float acc = 0.f;
        for (int w = 0; w < W; ++w) {
          const int c = (int)win[w];
          if (c >= 0) acc += ldw(front + ((long long)w * C + c) * R + r);
        }
        h[r] = acc;
        hr[r] = rnd<WT>(acc);
      }
    } else {
      // Front causal conv: h[r] = sum_w win[w] * front[r, w], 16 threads a
      // row.
      for (int r0 = 0; r0 < R; r0 += NT / 16) {
        const int r = r0 + r16;
        float acc = 0.f;
        if (r < R)
          for (int w = g16; w < W; w += 16)
            acc += rnd<WT>(win[w]) * ldw(front + r * W + w);
        for (int o = 8; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (g16 == 0 && r < R) {
          h[r] = acc;
          hr[r] = rnd<WT>(acc);
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      if constexpr (FIXED)
        run_chain<WT>(wring, full, empty, ready, t & 1, h, hr, olds, lcs,
                      gat, bres, cur, ring, L, lane, g_chain);
      else
        run_chain_any<WT>(wring, full, empty, ready, h, hr, olds, lcs, gat,
                          bres, cur, ring, L, R, D, NSLOT, lane, cs, cph);
    } else if (tid == PRODUCER) {
      // Refill each slot as the chain frees it: this step's layer l frees
      // the slot of layer slot g = t*L + l + NSLOT.
      for (int i = 0; i < L && g_load < n_slots; ++i, ++g_load) {
        mbar_wait(&empty[ps], pph ^ 1);
        issue_layer(wring, full, w_tap, w_res_t, ps, pl, TAP, RES);
        advance(ps, pph, pl, NSLOT, L);
      }
    } else if (skip_i >= 0) {
      skip_partial<WT>(gat, w_skip, ready, t & 1, L, D, S, part, skip_i,
                       lane);
    }
    __syncthreads();

    // The skip product's row groups summed, plus bias, relu; post1, relu.
    for (int s = tid; s < S; s += NT) {
      float v = 0.f;
      for (int j = 0; j < n_groups; ++j) v += part[j * S + s];
      z[s] = rnd<WT>(fmaxf(v + p.skip_bias[s], 0.f));
    }
    __syncthreads();
    dense_relu(z, post1, p.b1, S, S, z1, part, tid);
    // post2: one warp per output channel.
    for (int c = warp; c < C; c += NT / 32) {
      float acc = 0.f;
      for (int k = lane; k < S; k += 32)
        acc += z1[k] * ldw(post2_t + (long long)c * S + k);
      acc = warp_sum(acc);
      if (lane == 0) logits[c] = acc + p.b2[c];
    }
    __syncthreads();

    // Sampling by warp 0, then the window shift, 32 columns at a time from
    // the oldest: the new sample (or class) becomes the newest column.
    if (warp == 0) {
      const float x = p.quantized ? softmax_head(p, logits, t, b, lane, &rng)
                                  : mol_head(p, logits, t, b, lane, &rng);
      if (lane == 0) p.out[(long long)b * p.T + t] = x;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const int w = w0 + lane;
        const float nxt = (w < W - 1) ? win[w + 1] : x;
        __syncwarp();
        if (w < W) win[w] = nxt;
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// This thread's index among the skip threads (every warp but the chain
// warp, the producer's and the other warps of the chain warp's scheduler),
// or -1.
__device__ __forceinline__ int skip_index(int warp, int lane) {
  return (warp > 1 && warp % 4 != 0) ? (warp - warp / 4 - 2) * 32 + lane
                                      : -1;
}

// The cluster instance: block `rank` of stream b's k-block cluster (grid
// B*k, cluster (k, 1, 1)).  The same step as wavenet_gen_kernel's at run
// time widths, with this block's Dl = D/k gate channels; two cluster
// barriers a step: after the skip partials (block 0 then sums them) and
// after block 0 has stored the sample into every block's `xs`.
template <typename WT>
__global__ void __launch_bounds__(NT, 1) wavenet_gen_cluster_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int k = p.k, NSLOT = p.nslot;
  const int R = p.R, Dl = p.D / k, DL = p.Dlc;
  const int rank = blockIdx.x % k, b = blockIdx.x / k, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int L = p.L, W = p.W, S = p.S, C = p.C;
  const int TAP = 4 * R * Dl, RES = R * Dl;
  // This block's spans: tap rows [2 rank Dl, 2 (rank+1) Dl) of each layer
  // (layer stride k*TAP), residual columns [L, k, R, Dl] (stride k*RES),
  // skip rows [k, L*Dl, S].
  const WT* w_tap = static_cast<const WT*>(p.w_tap) + (long long)rank * TAP;
  const WT* w_res = static_cast<const WT*>(p.w_res_t) + (long long)rank * RES;
  const WT* w_skip =
      static_cast<const WT*>(p.w_skip) + (long long)rank * L * Dl * S;
  const WT* front = static_cast<const WT*>(p.front);
  const WT* post1 = static_cast<const WT*>(p.post1);
  const WT* post2_t = static_cast<const WT*>(p.post2_t);

  const Smem m = smem_layout(L, R, Dl, S, C, W, NSLOT, sizeof(WT), k);
  WT* wring = reinterpret_cast<WT*>(smem_raw);  // [NSLOT][TAP + RES]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + m.bars);
  uint64_t* empty = full + NSLOT;
  uint64_t* ready = empty + NSLOT;   // [L] layer l's gated output stored
  uint64_t* xbar = ready + L;        // [L] layer l's k partials stored
  float* win = reinterpret_cast<float*>(smem_raw + m.f32s);  // [W]
  float* h = win + up4(W);           // [R]   f32 layer-0 input
  float* hr = h + R;                 // [R]   the chain's input, rounded
  float* olds = hr + R;              // [L*R] history rows h[t-d] (rounded)
  float* lcs = olds + L * R;         // [L*2Dl] this block's lc row
  float* gat = lcs + L * 2 * Dl;     // [L*Dl] gated outputs (rounded)
  float* z = gat + L * Dl;           // [S]
  float* z1 = z + S;                 // [S]
  float* logits = z1 + S;            // [C]
  float* bres = logits + up4(C);     // [L*R] residual biases
  float* part = bres + L * R;        // [8 * NT] partial sums
  float* xch = part + 8 * NT;        // [2][k][R] residual partials
  float* zloc = xch + 2 * k * R;     // [S] this block's skip sums
  float* xs = zloc + S;              // [1] the step's sample (from block 0)
  int* dil = reinterpret_cast<int*>(smem_raw + m.ints);  // [L]
  int* roff = dil + L;               // [L] ring offset of each layer
  int* cur = roff + L;               // [L] this step's ring row of each layer

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int l = 0; l < L; ++l) {
      mbar_init(&ready[l], 32);
      mbar_init(&xbar[l], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < W; i += NT) win[i] = p.quantized ? -1.f : 0.f;
  for (int l = tid; l < L; l += NT) dil[l] = p.dil[l];
  for (int i = tid; i < L * R; i += NT) bres[i] = p.b_res[i];
  // Channels past the caller's D take no lc term: their entries stay 0.
  for (int i = tid; i < L * 2 * Dl; i += NT) lcs[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int l = 0; l < L; ++l) { roff[l] = o; o += dil[l] * R; }
  }
  // Every block's mbarriers are initialised before any peer arrives.
  cluster_sync();
  curandStatePhilox4_32_10_t rng;
  const bool philox = !p.deterministic && p.noise == nullptr;
  if (philox && warp == 0 && rank == 0)
    curand_init(p.seed, (unsigned long long)b * 32 + lane, 0, &rng);
  float* ring = p.ring + ((long long)b * k + rank) * p.ring_stride;
  const int LDL = L * 2 * DL;
  const float* lc_b = p.lc_proj + (long long)b * p.T * LDL;
  const long long n_slots = (long long)p.T * L;
  const int n_groups = skip_groups<WT>(S);
  long long g_load = 0;
  int ps = 0, pl = 0, cs = 0;
  unsigned pph = 0, cph = 0;
  const bool producer = tid == PRODUCER;
  if (producer) {
    for (; g_load < NSLOT && g_load < n_slots; ++g_load) {
      load_span(wring, full, w_tap + (long long)pl * k * TAP,
                 w_res + (long long)pl * k * RES, ps, TAP, RES);
      advance(ps, pph, pl, NSLOT, L);
    }
  }
  __syncthreads();

  const int r16 = tid >> 4, g16 = tid & 15;
  const int skip_i = skip_index(warp, lane);
  const uint32_t zloc_a = smem_addr(zloc), xs_a = smem_addr(xs);

  for (int t = 0; t < p.T; ++t) {
    if (tid == 0 && t < p.prime_len)
      win[W - 1] = p.primed[(long long)t * p.B + b];
    for (int i = tid; i < L * R; i += NT) {
      const int l = i / R;
      olds[i] = rnd<WT>(ring[roff[l] + (t % dil[l]) * R + (i % R)]);
    }
    for (int l = tid; l < L; l += NT) cur[l] = roff[l] + (t % dil[l]) * R;
    // This block's gate channels of the lc row: (layer, filter or gate) q,
    // channel rank*Dl + jl of the caller's DL.
    const float* lrow = lc_b + (long long)t * LDL;
    for (int i = tid; i < L * 2 * Dl; i += NT) {
      const int q = i / Dl, j = rank * Dl + (i - q * Dl);
      if (j < DL) lcs[i] = lrow[q * DL + j];
    }
    __syncthreads();

    if (p.quantized) {
      for (int r = tid; r < R; r += NT) {
        float acc = 0.f;
        for (int w = 0; w < W; ++w) {
          const int c = (int)win[w];
          if (c >= 0) acc += ldw(front + ((long long)w * C + c) * R + r);
        }
        h[r] = acc;
        hr[r] = rnd<WT>(acc);
      }
    } else {
      for (int r0 = 0; r0 < R; r0 += NT / 16) {
        const int r = r0 + r16;
        float acc = 0.f;
        if (r < R)
          for (int w = g16; w < W; w += 16)
            acc += rnd<WT>(win[w]) * ldw(front + r * W + w);
        for (int o = 8; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (g16 == 0 && r < R) {
          h[r] = acc;
          hr[r] = rnd<WT>(acc);
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      run_chain_cluster<WT>(wring, full, empty, ready, xbar, xch, t & 1, h,
                            hr, olds, lcs, gat, bres, cur, ring, L, R, Dl,
                            NSLOT, k, rank, lane, cs, cph);
    } else if (producer) {
      for (int i = 0; i < L && g_load < n_slots; ++i, ++g_load) {
        mbar_wait(&empty[ps], pph ^ 1);
        load_span(wring, full, w_tap + (long long)pl * k * TAP,
                   w_res + (long long)pl * k * RES, ps, TAP, RES);
        advance(ps, pph, pl, NSLOT, L);
      }
    } else if (skip_i >= 0) {
      skip_partial<WT>(gat, w_skip, ready, t & 1, L, Dl, S, part, skip_i,
                       lane);
    }
    __syncthreads();
    for (int s = tid; s < S; s += NT) {
      float v = 0.f;
      for (int g = 0; g < n_groups; ++g) v += part[g * S + s];
      zloc[s] = v;
    }
    cluster_sync();   // every block's skip sums are stored

    if (rank == 0) {
      for (int s = tid; s < S; s += NT) {
        float v = zloc[s];
        for (int q = 1; q < k; ++q) v += ld_cluster(mapa(zloc_a + 4u * s, q));
        z[s] = rnd<WT>(fmaxf(v + p.skip_bias[s], 0.f));
      }
      __syncthreads();
      dense_relu<WT>(z, post1, p.b1, S, S, z1, part, tid);
      for (int c = warp; c < C; c += NT / 32) {
        float acc = 0.f;
        for (int kk = lane; kk < S; kk += 32)
          acc += z1[kk] * ldw(post2_t + (long long)c * S + kk);
        acc = warp_sum(acc);
        if (lane == 0) logits[c] = acc + p.b2[c];
      }
      __syncthreads();
      if (warp == 0) {
        const float x = p.quantized
                            ? softmax_head(p, logits, t, b, lane, &rng)
                            : mol_head(p, logits, t, b, lane, &rng);
        if (lane == 0) {
          p.out[(long long)b * p.T + t] = x;
          for (int q = 0; q < k; ++q) st_cluster(mapa(xs_a, q), x);
        }
      }
    }
    cluster_sync();   // the sample is in every block's xs

    if (warp == 0) {
      const float x = xs[0];
      for (int w0 = 0; w0 < W; w0 += 32) {
        const int w = w0 + lane;
        const float nxt = (w < W - 1) ? win[w + 1] : x;
        __syncwarp();
        if (w < W) win[w] = nxt;
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // No block leaves while a peer may still touch its shared memory.
  cluster_sync();
}

// Launches the cluster instance: grid B*k, clusters of k blocks.  Returns
// a CUDA error, or -1000 - n when the card holds only n < B such clusters
// at once (a cluster's blocks must all be resident).
template <typename WT>
int launch_cluster(const Params& p, size_t smem, cudaStream_t stream) {
  void (*kern)(Params) = wavenet_gen_cluster_kernel<WT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.k);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n < p.B) return -1000 - n;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename WT, int RF>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      wavenet_gen_kernel<WT, RF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wavenet_gen_kernel<WT, RF><<<p.B, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// wn_moon's widths with the full ring take the R = D = 32 instance; a
// stream split over k > 1 blocks the cluster instance.
template <typename WT>
int launch_widths(Params p, cudaStream_t stream) {
  const int wsize = (int)sizeof(WT);
  if (p.k > 1) {
    const int Dl = p.D / p.k;
    p.nslot = fit_slots(p.L, p.R, Dl, p.S, p.C, p.W, wsize, p.k);
    if (p.nslot < 1) return (int)cudaErrorInvalidValue;
    return launch_cluster<WT>(
        p, smem_layout(p.L, p.R, Dl, p.S, p.C, p.W, p.nslot, wsize, p.k).total,
        stream);
  }
  p.nslot = fit_slots(p.L, p.R, p.D, p.S, p.C, p.W, wsize);
  if (p.nslot < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_layout(p.L, p.R, p.D, p.S, p.C, p.W, p.nslot, wsize).total;
  if (p.R == FW && p.D == FW && p.Dlc == FW && p.nslot == nslot<WT>())
    return launch<WT, FW>(p, smem, stream);
  return launch<WT, 0>(p, smem, stream);
}

}  // namespace

// Shared memory bytes a block of the sampler takes at the caller's widths
// (L layers, R residual, D gate and S skip channels, C output channels or
// classes, W front taps; bf16 != 0 for bf16 weights), with as many weight
// slots as fit; with one slot when not even one fits, and then the bytes
// exceed the 232,448 a block may use.
extern "C" int wavenet_gen_smem_bytes(int L, int R, int D, int S, int C,
                                      int W, int bf16) {
  const int wsize = bf16 ? 2 : 4;
  const int n = fit_slots(L, pad8(R), pad8(D), pad8(S), C, W, wsize);
  return (int)smem_layout(L, pad8(R), pad8(D), pad8(S), C, W, n > 0 ? n : 1,
                          wsize).total;
}

// The weight ring's slots at these widths (as above), or 0 when they do not
// fit.
extern "C" int wavenet_gen_slots(int L, int R, int D, int S, int C, int W,
                                 int bf16) {
  return fit_slots(L, pad8(R), pad8(D), pad8(S), C, W, bf16 ? 2 : 4);
}

// The plan at the caller's widths (as wavenet_gen_smem_bytes takes them):
// the fewest blocks per stream, 1, 2, 4 or 8, whose per-block layout fits
// (*blocks), that layout's weight slots (*slots, 0 when not even 8 blocks
// with one slot fit), and its shared memory bytes per block (returned).
extern "C" int wavenet_gen_plan(int L, int R, int D, int S, int C, int W,
                                int bf16, int* blocks, int* slots) {
  return plan(L, R, D, S, C, W, bf16 ? 2 : 4, blocks, slots);
}

// Launches the sampler on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted), or -1000 - n when the card holds only n < B
// clusters of `blocks` blocks at once.  R, D and S are the caller's
// widths: lc_proj is [B, T, L*2D], every other tensor is in the layout of
// R and S padded to multiples of 8 and D to a multiple of 8 * blocks
// (ops/wavenet_gen.py:kernel_layout; with blocks > 1 w_res_t and w_skip
// split per block, cluster_layout).  `front` is [R, W] for scalar input
// and [W, C, R] for the softmax head (quantized != 0); `bf16` selects
// __nv_bfloat16 weights; `blocks` (1, 2, 4 or 8) is the blocks per stream,
// and the ring scratch holds that many copies per stream.  The wrapper
// checks shapes, types and devices before calling.
extern "C" int wavenet_gen_launch(
    const float* lc_proj, const void* w_tap, const void* w_res_t,
    const float* b_res, const void* front, const void* w_skip,
    const float* skip_bias, const void* post1, const float* b1,
    const void* post2_t, const float* b2, const int* dil,
    const float* primed, const float* noise, float* ring, float* out,
    unsigned long long seed, long long ring_stride, int B, int T, int L,
    int R, int D, int W, int S, int C, int prime_len, int deterministic,
    int quantized, int bf16, float temperature, int blocks, void* stream) {
  const bool bad_head = quantized ? (C < 1 || !(temperature > 0.f))
                                  : (C < 3 || C % 3 != 0);
  // The bulk copies read 16-byte aligned spans.
  const bool misaligned =
      (reinterpret_cast<uintptr_t>(w_tap) | reinterpret_cast<uintptr_t>(w_res_t)) & 15;
  const bool bad_blocks = blocks != 1 && blocks != 2 && blocks != 4 &&
                          blocks != MAX_CLUSTER;
  if (B < 1 || T < 1 || L < 1 || R < 1 || D < 1 || W < 1 || S < 1 ||
      pad8(S) > MAX_S || bad_head || misaligned || bad_blocks ||
      (prime_len > 0 && primed == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{lc_proj, w_tap, w_res_t, b_res, front, w_skip, skip_bias,
           post1, b1, post2_t, b2, dil, primed, noise, ring, out,
           seed, ring_stride, B, T, L, pad8(R), pad_split(D, blocks), D, W,
           pad8(S), C, prime_len, deterministic, quantized, 0, temperature,
           blocks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_widths<__nv_bfloat16>(p, s) : launch_widths<float>(p, s);
}
