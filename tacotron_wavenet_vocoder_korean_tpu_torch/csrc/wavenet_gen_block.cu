// The block-synchronous step design of the generation kernel, kept as the
// baseline that wavenet_gen.cu's time is measured against (chip_smoke.py
// and ablate_gen.py build both and time them side by side).  It computes
// the same function through the same C entry point; the serving path never
// loads it.  In this design all 16 warps run every layer of the chain, with
// two block-wide barriers per layer and the tap weights read from L2 into
// registers one layer ahead; the skip product follows the chain.
//
// Persistent autoregressive WaveNet sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/wavenet_pallas.py:pallas_generate (body
// make_generate_kernel) of the JAX package, with both of its sampling heads
// and both of its weight types.  It computes the same function (front causal
// conv, L gated dilated layers reading their history at ring slot t mod d,
// deferred skip product, relu -> post1 -> relu -> post2, then the head;
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
// Design.  One thread block per stream (B <= 8 in practice), persistent: it
// loops over all T samples itself, because blocks run in no order and
// nothing carries over between them.  16 warps; __syncthreads() separates
// the dependent stages of a sample.  Shared memory holds the window, h [R]
// (and its rounded copy), the history rows and lc projection row of the
// current step, the L*D gated outputs kept for the deferred skip product,
// the skip/post buffers and the logits (about 31 KB for the full model;
// bf16 adds 16 KB of partial sums).  Activations are rounded to the weight
// type once, where they are stored.  The ring histories
// (sum(d)*R f32 per stream, ~655 KB) live in a zeroed global scratch; the
// weights (~5.4 MB in f32, half that in bf16; the softmax head adds a
// [256, 512] post2) stay resident in the 50 MB L2.
//
// What bounds it on this card: a serial latency chain of L = 50 dependent
// layers per sample (two barriers each), and every weight streamed from L2
// into one SM per stream, the skip matrix above all (3.2 MB in f32).
// Builds with parts removed (H100) put the chain at about half of an f32
// step and the skip product at about a third; bf16 halves the skip bytes
// and reads them with 16-byte loads.  The card's arithmetic and memory
// rates are far from the limit.  A later version would split each
// stream's weights across a thread-block cluster's shared memory and use
// warp-level MMA for the [B, .] products of all streams at once.
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
constexpr int D = 32;      // dilation (gate) channels
constexpr int NT = 512;    // threads: 2D pre-activation rows x 8 K-splits
constexpr int MAX_MOL = 96;   // MoL output channels (3 * nr_mix, nr_mix <= 32)
constexpr int MAX_C = 256;    // output channels (softmax head: Q <= 256)
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr float U_MIN = 1e-5f;
constexpr float U_MAX = 1.0f - 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

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

// Eight consecutive weights of one pre-activation row (16-byte aligned),
// dotted with eight activations already rounded to the weight type.
template <typename WT> struct Row8;
template <> struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float dot(const float* x) const {
    return x[0] * a.x + x[1] * a.y + x[2] * a.z + x[3] * a.w
         + x[4] * b.x + x[5] * b.y + x[6] * b.z + x[7] * b.w;
  }
};
template <> struct Row8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int i) const {  // i a constant
    switch (i) {
      case 0: return bf16_lo(v.x); case 1: return bf16_hi(v.x);
      case 2: return bf16_lo(v.y); case 3: return bf16_hi(v.y);
      case 4: return bf16_lo(v.z); case 5: return bf16_hi(v.z);
      case 6: return bf16_lo(v.w); default: return bf16_hi(v.w);
    }
  }
  __device__ __forceinline__ float dot(const float* x) const {
    return x[0] * bf16_lo(v.x) + x[1] * bf16_hi(v.x)
         + x[2] * bf16_lo(v.y) + x[3] * bf16_hi(v.y)
         + x[4] * bf16_lo(v.z) + x[5] * bf16_hi(v.z)
         + x[6] * bf16_lo(v.w) + x[7] * bf16_hi(v.w);
  }
};

// Two consecutive weights of one residual row.
template <typename WT> struct Row2;
template <> struct Row2<float> {
  float2 a;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ float w0() const { return a.x; }
  __device__ __forceinline__ float w1() const { return a.y; }
};
template <> struct Row2<__nv_bfloat16> {
  uint32_t v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ float w0() const { return bf16_lo(v); }
  __device__ __forceinline__ float w1() const { return bf16_hi(v); }
};

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
        Row8<WT> w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) w[u].load(col + (long long)(k + u) * S);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float xv = x[k + u];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += xv * w[u].at(i);
        }
      }
      for (; k < k1; ++k) {
        Row8<WT> w0;
        w0.load(col + (long long)k * S);
        const float xv = x[k];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += xv * w0.at(i);
      }
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

template <typename WT>
__global__ void __launch_bounds__(NT, 1) wavenet_gen_kernel(Params p) {
  extern __shared__ float smem[];
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

  float* win = smem;                 // [32]
  float* h = win + 32;               // [R]   f32 layer input
  float* hr = h + R;                 // [R]   the same, rounded
  float* olds = hr + R;              // [L*R] history rows h[t-d] (rounded)
  float* lcs = olds + L * R;         // [L*2D] lc projection row of this step
  float* gat = lcs + LD2;            // [L*D] gated outputs (rounded)
  float* z = gat + L * D;            // [S]
  float* z1 = z + S;                 // [S]
  float* logits = z1 + S;            // [MAX_C]
  int* dil = reinterpret_cast<int*>(logits + MAX_C);  // [L]
  int* roff = dil + L;               // [L] ring offset of each layer
  float* part = reinterpret_cast<float*>(roff + L);  // bf16: [8 * NT] sums

  if (tid < 32) win[tid] = p.quantized ? -1.f : 0.f;
  for (int l = tid; l < L; l += NT) dil[l] = p.dil[l];
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
  __syncthreads();

  // Thread roles: (row n = 2j+f, K-split g8) for the pre-activations,
  // (channel r, K-split g16) for the front conv and the residual update.
  const int n_row = tid >> 3, g8 = tid & 7;
  const int r16 = tid >> 4, g16 = tid & 15;

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

    // Weights of layer 0; each layer prefetches the next one's.
    const WT* wt = w_tap + (long long)n_row * 2 * R + g8 * 8;
    Row8<WT> wrow;
    wrow.load(wt);
    Row2<WT> wr;
    wr.load(w_res_t + (long long)r16 * D + 2 * g16);

    for (int l = 0; l < L; ++l) {
      // This layer's input goes into its ring at slot t mod d.
      if (tid < R) ring[roff[l] + (t % dil[l]) * R + tid] = h[tid];

      // Pre-activation row n over [old tap | current tap] (K = 2R).
      {
        const float* x = (g8 < 4) ? (olds + l * R + g8 * 8) : (hr + (g8 - 4) * 8);
        float acc = wrow.dot(x);
        acc += __shfl_xor_sync(FULL, acc, 4);
        acc += __shfl_xor_sync(FULL, acc, 2);
        acc += __shfl_xor_sync(FULL, acc, 1);
        const float gate_acc = __shfl_down_sync(FULL, acc, 8);  // row n+1
        if ((tid & 15) == 0) {            // f == 0, g == 0: channel j
          const int j = tid >> 4;
          const float f = acc + lcs[l * 2 * D + j];
          const float g = gate_acc + lcs[l * 2 * D + D + j];
          gat[l * D + j] = rnd<WT>(tanhf(f) * (1.f / (1.f + expf(-g))));
        }
        if (l + 1 < L) {
          wt += 2 * D * 2 * R;
          wrow.load(wt);
        }
      }
      __syncthreads();

      // Residual: h[r] += b_res[r] + sum_j gated[j] * w_res[j, r].
      {
        float acc = gat[l * D + 2 * g16] * wr.w0()
                  + gat[l * D + 2 * g16 + 1] * wr.w1();
        for (int o = 8; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (g16 == 0) {
          const float v = h[r16] + (acc + p.b_res[l * R + r16]);
          h[r16] = v;
          hr[r16] = rnd<WT>(v);
        }
        if (l + 1 < L)
          wr.load(w_res_t + ((long long)(l + 1) * R + r16) * D + 2 * g16);
      }
      __syncthreads();
    }

    // Deferred skip product [L*D] @ [L*D, S], then relu; post1, then relu.
    dense_relu(gat, w_skip, p.skip_bias, L * D, S, z, part, tid);
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
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wavenet_gen_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
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
  if (B < 1 || T < 1 || L < 1 || W < 1 || W > 32 || S % 8 != 0 ||
      S > 8 * NT || bad_head ||
      (prime_len > 0 && primed == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{lc_proj, w_tap, w_res_t, b_res, front, w_skip, skip_bias,
           post1, b1, post2_t, b2, dil, primed, noise, ring, out,
           seed, ring_stride, B, T, L, W, S, C, prime_len, deterministic,
           quantized, temperature};
  const size_t smem = sizeof(float) * (32 + 2 * R + (size_t)L * R +
                                       (size_t)L * 2 * D + (size_t)L * D +
                                       2 * (size_t)S + MAX_C +
                                       (bf16 ? 8 * NT : 0)) +
                      sizeof(int) * 2 * (size_t)L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, smem, s) : launch<float>(p, smem, s);
}
