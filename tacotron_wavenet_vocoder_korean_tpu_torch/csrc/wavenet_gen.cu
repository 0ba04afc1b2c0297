// Persistent autoregressive WaveNet sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/wavenet_pallas.py:pallas_generate (body
// make_generate_kernel) of the JAX package, with both of its sampling heads
// and both of its weight types.  It computes the same function (front causal
// conv, L gated dilated layers reading their history at ring slot t mod d,
// the skip product, relu -> post1 -> relu -> post2, then the head;
// teacher-forced priming for t < prime_len, window shift), but not K1's
// algebraically fused residual chain, which was tuned for the TPU's
// matrix-unit turnaround: this kernel runs the unfused math on its own
// packed layout (ops/wavenet_gen.py:pack_params).
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
// Design.  One thread block of 16 warps per stream (B <= 8 in practice),
// persistent: it loops over all T samples itself, because blocks run in no
// order and nothing carries over between them.  A step stages its history
// rows and lc row and runs the front conv; then three roles run at once,
// with no block-wide barrier until all L layers are done:
// - the chain warp (warp 0) runs the L gated layers alone: lane j owns
//   gate channel j (its filter and gate rows over the 2R inputs, tanh *
//   sigmoid in its own registers); after a __syncwarp lane r takes the 32
//   gated values from shared memory for its residual row and keeps h[r] in
//   a register.  Lanes read their weight rows at a rotated chunk order, so
//   the 16-byte shared loads of a quarter-warp fall in distinct banks;
// - one producer thread (warp 1) keeps a ring of NSLOT layer slots in
//   shared memory filled with each layer's tap and residual weights by
//   Hopper's bulk async copy (cp.async.bulk, completed on a "full"
//   mbarrier; the chain frees a slot on its "empty" mbarrier).  The ring
//   wraps across steps, so the next step's first layers load during this
//   step's tail;
// - the skip warps (all but warp 0, warp 1 and the other warps of warp 0's
//   scheduler) accumulate the skip product from each layer's gated output
//   as the chain publishes it (one mbarrier per layer), in partial sums.
// A block-wide barrier then hands the skip sums to relu, post1, post2 and
// the head.  Shared memory holds the weight ring (80 KB), the window, h,
// the history rows, lc row, gated outputs, skip/post buffers, logits and
// partial sums (about 55 KB for the full model).  Activations are rounded
// to the weight type once, where they are stored.  The ring histories
// (sum(d)*R f32 per stream, ~655 KB) live in a zeroed global scratch; the
// weights (~5.4 MB in f32, half that in bf16; the softmax head adds a
// [256, 512] post2) stay resident in the 50 MB L2.
//
// What bounds it on this card: the chain is a serial latency chain of L =
// 50 dependent layers, one warp's instruction latency per layer (its
// shared loads, multiply-adds, tanh and exp, two __syncwarp), ~0.5 us a
// layer on an H100; and the skip product's weights (1.6 MB a step in bf16,
// 3.2 MB in f32) stream from L2 into one SM, at a rate set by the loads
// each skip thread keeps in flight.  The two share the SM's memory pipe:
// run together they take longer than either alone.  The card's arithmetic
// and memory rates are far from the limit.  Later versions would split
// each stream's weights across a thread-block cluster's shared memory,
// serve all streams from one weight read, and use warp-level MMA.
//
// Noise: counter-based Philox (curand_kernel.h), seeded by the wrapper from
// a torch.Generator, one subsequence per (stream, lane) of warp 0; or, for
// tests, a noise tensor of uniforms ([T, B, nr_mix+1] for MoL, [T, B, Q]
// for the softmax head) that replaces it.  Uniforms are clipped to
// [1e-5, 1-1e-5].  In deterministic MoL mode tied maxima are averaged, as
// K1 does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int R = 32;      // residual channels
constexpr int D = 32;      // dilation (gate) channels: one per chain lane
constexpr int NT = 512;    // threads: 16 warps
constexpr int PRODUCER = 32;  // the thread that issues the weight copies
// Skip warps: every warp but the chain warp, the producer's and the other
// warps of the chain warp's scheduler (warp w issues on scheduler w mod 4),
// so the chain has its scheduler to itself.
constexpr int NSK = 32 * (NT / 32 - NT / 128 - 1);
constexpr int TAP = 2 * D * 2 * R;  // one layer's w_tap [2D, 2R]
constexpr int RES = R * D;          // one layer's w_res_t [R, D]
constexpr int MAX_MOL = 96;   // MoL output channels (3 * nr_mix, nr_mix <= 32)
constexpr int MAX_C = 256;    // output channels (softmax head: Q <= 256)
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr float U_MIN = 1e-5f;
constexpr float U_MAX = 1.0f - 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

// Layer slots of the weight ring: 80 KB of shared memory either way.
template <typename WT>
__host__ __device__ constexpr int nslot() { return sizeof(WT) == 2 ? 8 : 4; }

// Byte offsets into the dynamic shared memory: the weight ring, its
// mbarriers, the f32 buffers, the int tables.
struct Smem {
  unsigned bars, f32s, ints, total;
};
__host__ __device__ inline Smem smem_layout(int L, int S, int nslot,
                                            int wsize) {
  Smem m;
  m.bars = (unsigned)(nslot * (TAP + RES) * wsize);
  m.f32s = (m.bars + 8u * (2 * nslot + L) + 15u) & ~15u;
  const unsigned floats = 32 + 2 * R + L * R + L * 2 * D + L * D + 2 * S +
                          MAX_C + L * R + 8 * NT;
  m.ints = m.f32s + 4u * floats;
  m.total = m.ints + 4u * 3 * L;
  return m;
}

struct Params {
  const float* lc_proj;    // [B, T, L*2D]   per layer [filter D | gate D]
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
  float* ring;             // [B, ring_stride] zeroed
  float* out;              // [B, T]
  unsigned long long seed;
  long long ring_stride;
  int B, T, L, W, S, C, prime_len, deterministic, quantized;
  float temperature;
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
// sums (in `part`, [8 * NT]) added after a barrier.
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
// logistic inverse CDF, clipped to [-1, 1].
__device__ float mol_head(const Params& p, const float* logits, int t, int b,
                          int lane, curandStatePhilox4_32_10_t* rng) {
  const int nr = p.C / 3;
  float u_sel = 0.5f, u = 0.5f;
  if (!p.deterministic) {
    if (p.noise == nullptr) {
      if (lane < nr) u_sel = clip_u(curand_uniform(rng));
      const float u0 = (lane == 0) ? curand_uniform(rng) : 0.f;
      u = clip_u(__shfl_sync(FULL, u0, 0));
    } else {
      const float* nz = p.noise + ((long long)t * p.B + b) * (nr + 1);
      if (lane < nr) u_sel = clip_u(nz[lane]);
      u = clip_u(nz[nr]);
    }
  }
  float score = -INFINITY;
  if (lane < nr)
    score = p.deterministic ? logits[lane] : logits[lane] - logf(-logf(u_sel));
  const float m = warp_max(score);
  const float sel = (lane < nr && score >= m) ? 1.f : 0.f;
  const float cnt = warp_sum(sel);     // ties share the weight
  const float mean = warp_sum(lane < nr ? sel * logits[nr + lane] : 0.f) / cnt;
  if (p.deterministic) return fminf(fmaxf(mean, -1.f), 1.f);
  const float ls = fmaxf(
      warp_sum(lane < nr ? sel * logits[2 * nr + lane] : 0.f) / cnt,
      LOG_SCALE_MIN);
  const float x = mean + expf(ls) * (logf(u) - logf(1.f - u));
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
                                             unsigned parity, int L, int S,
                                             float* part, int i, int lane) {
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

// The chain warp's L layers of step t.  `g` counts the layer slots the
// chain has consumed over the launch (slot g mod NSLOT, phase g / NSLOT);
// layer l's gated output completes phase `parity` of ready[l].
template <typename WT>
__device__ __forceinline__ void run_chain(
    const WT* wring, uint64_t* full, uint64_t* empty, uint64_t* ready,
    unsigned parity, const float* h,
    float* hr, const float* olds, const float* lcs, float* gat,
    const float* bres, const int* cur, float* ring, int L, int lane,
    long long& g) {
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

// Layer slot g of the launch: layer g mod L's tap and residual weights.
template <typename WT>
__device__ __forceinline__ void issue_layer(WT* wring, uint64_t* full,
                                            const WT* w_tap,
                                            const WT* w_res_t, int L,
                                            long long g) {
  const int s = (int)(g % nslot<WT>());
  const long long l = g % L;
  WT* dst = wring + s * (TAP + RES);
  mbar_expect_tx(&full[s], (TAP + RES) * sizeof(WT));
  bulk_copy(dst, w_tap + l * TAP, TAP * sizeof(WT), &full[s]);
  bulk_copy(dst + TAP, w_res_t + l * RES, RES * sizeof(WT), &full[s]);
}

template <typename WT>
__global__ void __launch_bounds__(NT, 1) wavenet_gen_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NSLOT = nslot<WT>();
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int L = p.L, W = p.W, S = p.S, C = p.C;
  const int LD2 = L * 2 * D;
  const WT* w_tap = static_cast<const WT*>(p.w_tap);
  const WT* w_res_t = static_cast<const WT*>(p.w_res_t);
  const WT* front = static_cast<const WT*>(p.front);
  const WT* w_skip = static_cast<const WT*>(p.w_skip);
  const WT* post1 = static_cast<const WT*>(p.post1);
  const WT* post2_t = static_cast<const WT*>(p.post2_t);

  const Smem m = smem_layout(L, S, NSLOT, sizeof(WT));
  WT* wring = reinterpret_cast<WT*>(smem_raw);  // [NSLOT][TAP + RES]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + m.bars);
  uint64_t* empty = full + NSLOT;
  uint64_t* ready = empty + NSLOT;   // [L] layer l's gated output stored
  float* win = reinterpret_cast<float*>(smem_raw + m.f32s);  // [32]
  float* h = win + 32;               // [R]   f32 layer-0 input
  float* hr = h + R;                 // [R]   the chain's input, rounded
  float* olds = hr + R;              // [L*R] history rows h[t-d] (rounded)
  float* lcs = olds + L * R;         // [L*2D] lc projection row of this step
  float* gat = lcs + LD2;            // [L*D] gated outputs (rounded)
  float* z = gat + L * D;            // [S]
  float* z1 = z + S;                 // [S]
  float* logits = z1 + S;            // [MAX_C]
  float* bres = logits + MAX_C;      // [L*R] residual biases
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
  if (tid < 32) win[tid] = p.quantized ? -1.f : 0.f;
  for (int l = tid; l < L; l += NT) dil[l] = p.dil[l];
  for (int i = tid; i < L * R; i += NT) bres[i] = p.b_res[i];
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
  const float* lc_b = p.lc_proj + (long long)b * p.T * LD2;
  // The producer's next layer slot, and the chain's.
  const long long n_slots = (long long)p.T * L;
  const int n_groups = skip_groups<WT>(S);   // the skip's row groups
  long long g_load = 0, g_chain = 0;
  if (tid == PRODUCER)
    for (; g_load < NSLOT && g_load < n_slots; ++g_load)
      issue_layer(wring, full, w_tap, w_res_t, L, g_load);
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
    // step's stores) and the lc projection row.
    for (int i = tid; i < L * R; i += NT) {
      const int l = i / R;
      olds[i] = rnd<WT>(ring[roff[l] + (t % dil[l]) * R + (i % R)]);
    }
    for (int l = tid; l < L; l += NT) cur[l] = roff[l] + (t % dil[l]) * R;
    const float* lrow = lc_b + (long long)t * LD2;
    for (int i = tid; i < LD2; i += NT) lcs[i] = lrow[i];
    __syncthreads();

    if (p.quantized) {
      // One-hot front conv: h[r] = sum over the window's classes c_w >= 0
      // of front[w, c_w, r].
      if (tid < R) {
        float acc = 0.f;
        for (int w = 0; w < W; ++w) {
          const int c = (int)win[w];
          if (c >= 0) acc += ldw(front + ((long long)w * C + c) * R + tid);
        }
        h[tid] = acc;
        hr[tid] = rnd<WT>(acc);
      }
    } else {
      // Front causal conv: h[r] = sum_w win[w] * front[w, r].
      float acc = 0.f;
      for (int w = g16; w < W; w += 16)
        acc += rnd<WT>(win[w]) * ldw(front + r16 * W + w);
      for (int o = 8; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (g16 == 0) {
        h[r16] = acc;
        hr[r16] = rnd<WT>(acc);
      }
    }
    __syncthreads();

    if (warp == 0) {
      run_chain<WT>(wring, full, empty, ready, t & 1, h, hr, olds, lcs, gat,
                    bres, cur, ring, L, lane, g_chain);
    } else if (tid == PRODUCER) {
      // Refill each slot as the chain frees it: this step's layer l frees
      // the slot of layer slot g = t*L + l + NSLOT.
      for (int i = 0; i < L && g_load < n_slots; ++i, ++g_load) {
        mbar_wait(&empty[g_load % NSLOT],
                  (unsigned)(((g_load / NSLOT) & 1) ^ 1));
        issue_layer(wring, full, w_tap, w_res_t, L, g_load);
      }
    } else if (skip_i >= 0) {
      skip_partial<WT>(gat, w_skip, ready, t & 1, L, S, part, skip_i, lane);
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

    // Sampling by warp 0, then the window shift: the new sample (or class)
    // becomes the window's newest column.
    if (warp == 0) {
      const float x = p.quantized ? softmax_head(p, logits, t, b, lane, &rng)
                                  : mol_head(p, logits, t, b, lane, &rng);
      if (lane == 0) p.out[(long long)b * p.T + t] = x;
      const float nxt = (lane < W - 1) ? win[lane + 1] : x;
      __syncwarp();
      if (lane < W) win[lane] = nxt;
      __syncwarp();
    }
    __syncthreads();
  }
}

template <typename WT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_layout(p.L, p.S, nslot<WT>(), sizeof(WT)).total;
  cudaError_t e = cudaFuncSetAttribute(
      wavenet_gen_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wavenet_gen_kernel<WT><<<p.B, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the sampler on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  `front` is [R, W] for scalar input and
// [W, C, R] for the softmax head (quantized != 0); `bf16` selects
// __nv_bfloat16 weights.  The wrapper (ops/wavenet_gen.py) checks shapes,
// types and devices before calling.
extern "C" int wavenet_gen_launch(
    const float* lc_proj, const void* w_tap, const void* w_res_t,
    const float* b_res, const void* front, const void* w_skip,
    const float* skip_bias, const void* post1, const float* b1,
    const void* post2_t, const float* b2, const int* dil,
    const float* primed, const float* noise, float* ring, float* out,
    unsigned long long seed, long long ring_stride, int B, int T, int L,
    int W, int S, int C, int prime_len, int deterministic, int quantized,
    int bf16, float temperature, void* stream) {
  const bool bad_head = quantized ? (C < 1 || C > MAX_C || !(temperature > 0.f))
                                  : (C % 3 != 0 || C > MAX_MOL);
  // The bulk copies read 16-byte aligned spans.
  const bool misaligned =
      (reinterpret_cast<uintptr_t>(w_tap) | reinterpret_cast<uintptr_t>(w_res_t)) & 15;
  if (B < 1 || T < 1 || L < 1 || W < 1 || W > 32 || S % 8 != 0 ||
      S > 8 * NT || bad_head || misaligned ||
      (prime_len > 0 && primed == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{lc_proj, w_tap, w_res_t, b_res, front, w_skip, skip_bias,
           post1, b1, post2_t, b2, dil, primed, noise, ring, out,
           seed, ring_stride, B, T, L, W, S, C, prime_len, deterministic,
           quantized, temperature};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
