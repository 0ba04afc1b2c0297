// Persistent autoregressive WaveNet sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/wavenet_pallas.py:pallas_generate (body
// make_generate_kernel) of the JAX package.  It computes the same function
// (front causal conv over a W-sample window, L gated dilated layers reading
// their history at ring slot t mod d, deferred skip product, relu -> post1
// -> relu -> post2, mixture-of-logistics sampling, teacher-forced priming
// for t < prime_len, window shift), but not K1's algebraically fused
// residual chain, which was tuned for the TPU's matrix-unit turnaround: this
// kernel runs the unfused math on its own packed layout
// (ops/wavenet_gen.py:pack_params).
//
// Design.  One thread block per stream (B <= 8 in practice), persistent: it
// loops over all T samples itself, because blocks run in no order and
// nothing carries over between them.  16 warps; __syncthreads() separates
// the dependent stages of a sample.  Shared memory holds the W-sample
// window, h [R], the history rows and lc projection row of the current
// step, the L*D gated outputs kept for the deferred skip product, and the
// skip/post buffers (about 30 KB for the full model).  The ring histories
// (sum(d)*R f32 per stream, ~655 KB) live in a zeroed global scratch; the
// ~5.4 MB of f32 weights stay resident in the 50 MB L2.
//
// What bounds it on this card: a serial latency chain of L = 50 dependent
// layers per sample (two barriers each), with every weight streamed from L2
// into one SM per stream, the 3.2 MB skip matrix above all.  The card's
// arithmetic and memory rates are far from the limit.  A later version
// would split each stream's weights across a thread-block cluster's shared
// memory, store weights in bf16, and use warp-level MMA for the [B, .]
// products of all streams at once.
//
// Noise: counter-based Philox (curand_kernel.h), seeded by the wrapper from
// a torch.Generator, one subsequence per (stream, lane); or, for tests, a
// noise tensor [T, B, nr_mix+1] of uniforms that replaces it.  Uniforms are
// clipped to [1e-5, 1-1e-5].  In deterministic mode tied maxima are
// averaged, as K1 does.
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int R = 32;     // residual channels
constexpr int D = 32;     // dilation (gate) channels
constexpr int NT = 512;   // threads: 2D pre-activation rows x 8 K-splits
constexpr int MAX_C = 96; // output channels (3 * nr_mix, nr_mix <= 32)
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr float U_MIN = 1e-5f;
constexpr float U_MAX = 1.0f - 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* lc_proj;    // [B, T, L*2D]   per layer [filter D | gate D]
  const float* w_tap;      // [L, 2D, 2R]    row 2j+f, cols [old tap | cur tap]
  const float* w_res_t;    // [L, R, D]
  const float* b_res;      // [L, R]
  const float* front_t;    // [R, W]
  const float* w_skip;     // [L*D, S]
  const float* skip_bias;  // [S]
  const float* post1;      // [S, S]
  const float* b1;         // [S]
  const float* post2_t;    // [C, S]
  const float* b2;         // [C]
  const int* dil;          // [L]
  const float* primed;     // [T, B] or null
  const float* noise;      // [T, B, nr+1] or null
  float* ring;             // [B, ring_stride] zeroed
  float* out;              // [B, T]
  unsigned long long seed;
  long long ring_stride;
  int B, T, L, W, S, C, prime_len, deterministic;
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

__global__ void __launch_bounds__(NT, 1) wavenet_gen_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int L = p.L, W = p.W, S = p.S, C = p.C, nr = C / 3;
  const int LD2 = L * 2 * D;

  float* win = smem;                 // [32]
  float* h = win + 32;               // [R]
  float* olds = h + R;               // [L*R] history rows h[t-d] of this step
  float* lcs = olds + L * R;         // [L*2D] lc projection row of this step
  float* gat = lcs + LD2;            // [L*D] gated outputs
  float* z = gat + L * D;            // [S]
  float* z1 = z + S;                 // [S]
  float* logits = z1 + S;            // [MAX_C]
  int* dil = reinterpret_cast<int*>(logits + MAX_C);  // [L]
  int* roff = dil + L;               // [L] ring offset of each layer

  if (tid < 32) win[tid] = 0.f;
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
      olds[i] = ring[roff[l] + (t % dil[l]) * R + (i % R)];
    }
    const float* lrow = lc_b + (long long)t * LD2;
    for (int i = tid; i < LD2; i += NT) lcs[i] = lrow[i];
    __syncthreads();

    // Front causal conv: h[r] = sum_w win[w] * front[w, r].
    {
      float acc = 0.f;
      for (int w = g16; w < W; w += 16) acc += win[w] * p.front_t[r16 * W + w];
      for (int o = 8; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (g16 == 0) h[r16] = acc;
    }
    __syncthreads();

    // Weights of layer 0; each layer prefetches the next one's.
    const float4* wt = reinterpret_cast<const float4*>(
        p.w_tap + (long long)n_row * 2 * R + g8 * 8);
    float4 w0 = __ldg(wt), w1 = __ldg(wt + 1);
    float2 wr = __ldg(reinterpret_cast<const float2*>(
        p.w_res_t + (long long)r16 * D + 2 * g16));

    for (int l = 0; l < L; ++l) {
      // This layer's input goes into its ring at slot t mod d.
      if (tid < R) ring[roff[l] + (t % dil[l]) * R + tid] = h[tid];

      // Pre-activation row n over [old tap | current tap] (K = 2R).
      {
        const float* x = (g8 < 4) ? (olds + l * R + g8 * 8) : (h + (g8 - 4) * 8);
        float acc = x[0] * w0.x + x[1] * w0.y + x[2] * w0.z + x[3] * w0.w
                  + x[4] * w1.x + x[5] * w1.y + x[6] * w1.z + x[7] * w1.w;
        acc += __shfl_xor_sync(FULL, acc, 4);
        acc += __shfl_xor_sync(FULL, acc, 2);
        acc += __shfl_xor_sync(FULL, acc, 1);
        const float gate_acc = __shfl_down_sync(FULL, acc, 8);  // row n+1
        if ((tid & 15) == 0) {            // f == 0, g == 0: channel j
          const int j = tid >> 4;
          const float f = acc + lcs[l * 2 * D + j];
          const float g = gate_acc + lcs[l * 2 * D + D + j];
          gat[l * D + j] = tanhf(f) * (1.f / (1.f + expf(-g)));
        }
        if (l + 1 < L) {
          wt += (2 * D * 2 * R) / 4;
          w0 = __ldg(wt);
          w1 = __ldg(wt + 1);
        }
      }
      __syncthreads();

      // Residual: h[r] += b_res[r] + sum_j gated[j] * w_res[j, r].
      {
        float acc = gat[l * D + 2 * g16] * wr.x + gat[l * D + 2 * g16 + 1] * wr.y;
        for (int o = 8; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (g16 == 0) h[r16] += acc + p.b_res[l * R + r16];
        if (l + 1 < L)
          wr = __ldg(reinterpret_cast<const float2*>(
              p.w_res_t + ((long long)(l + 1) * R + r16) * D + 2 * g16));
      }
      __syncthreads();
    }

    // Deferred skip product [L*D] @ [L*D, S], then relu.
    const int K = L * D;
    for (int s = tid; s < S; s += NT) {
      const float* wc = p.w_skip + s;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int k = 0; k < K; k += 4) {
        a0 += gat[k] * __ldg(wc + (long long)k * S);
        a1 += gat[k + 1] * __ldg(wc + (long long)(k + 1) * S);
        a2 += gat[k + 2] * __ldg(wc + (long long)(k + 2) * S);
        a3 += gat[k + 3] * __ldg(wc + (long long)(k + 3) * S);
      }
      z[s] = fmaxf((a0 + a1) + (a2 + a3) + p.skip_bias[s], 0.f);
    }
    __syncthreads();
    // post1, then relu.
    for (int s = tid; s < S; s += NT) {
      const float* wc = p.post1 + s;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int k = 0; k < S; k += 4) {
        a0 += z[k] * __ldg(wc + (long long)k * S);
        a1 += z[k + 1] * __ldg(wc + (long long)(k + 1) * S);
        a2 += z[k + 2] * __ldg(wc + (long long)(k + 2) * S);
        a3 += z[k + 3] * __ldg(wc + (long long)(k + 3) * S);
      }
      z1[s] = fmaxf((a0 + a1) + (a2 + a3) + p.b1[s], 0.f);
    }
    __syncthreads();
    // post2: one warp per output channel.
    for (int c = warp; c < C; c += NT / 32) {
      float acc = 0.f;
      for (int k = lane; k < S; k += 32)
        acc += z1[k] * __ldg(p.post2_t + (long long)c * S + k);
      acc = warp_sum(acc);
      if (lane == 0) logits[c] = acc + p.b2[c];
    }
    __syncthreads();

    // Mixture-of-logistics sampling by warp 0: Gumbel-max component, then
    // the logistic inverse CDF, clipped to [-1, 1].
    if (warp == 0) {
      float u_sel = 0.5f, u = 0.5f;
      if (!p.deterministic) {
        if (philox) {
          if (lane < nr) u_sel = clip_u(curand_uniform(&rng));
          const float u0 = (lane == 0) ? curand_uniform(&rng) : 0.f;
          u = clip_u(__shfl_sync(FULL, u0, 0));
        } else {
          const float* nz = p.noise + ((long long)t * p.B + b) * (nr + 1);
          if (lane < nr) u_sel = clip_u(nz[lane]);
          u = clip_u(nz[nr]);
        }
      }
      float score = -INFINITY;
      if (lane < nr)
        score = p.deterministic ? logits[lane]
                                : logits[lane] - logf(-logf(u_sel));
      const float m = warp_max(score);
      const float sel = (lane < nr && score >= m) ? 1.f : 0.f;
      const float cnt = warp_sum(sel);     // ties share the weight
      const float mean = warp_sum(lane < nr ? sel * logits[nr + lane] : 0.f) / cnt;
      float x;
      if (p.deterministic) {
        x = fminf(fmaxf(mean, -1.f), 1.f);
      } else {
        const float ls = fmaxf(
            warp_sum(lane < nr ? sel * logits[2 * nr + lane] : 0.f) / cnt,
            LOG_SCALE_MIN);
        x = mean + expf(ls) * (logf(u) - logf(1.f - u));
        x = fminf(fmaxf(x, -1.f), 1.f);
      }
      if (lane == 0) p.out[(long long)b * p.T + t] = x;
      // Shift the window; the new sample becomes its newest column.
      const float nxt = (lane < W - 1) ? win[lane + 1] : x;
      __syncwarp();
      if (lane < W) win[lane] = nxt;
      __syncwarp();
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the sampler on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  The wrapper (ops/wavenet_gen.py) checks shapes,
// types and devices before calling.
extern "C" int wavenet_gen_launch(
    const float* lc_proj, const float* w_tap, const float* w_res_t,
    const float* b_res, const float* front_t, const float* w_skip,
    const float* skip_bias, const float* post1, const float* b1,
    const float* post2_t, const float* b2, const int* dil,
    const float* primed, const float* noise, float* ring, float* out,
    unsigned long long seed, long long ring_stride, int B, int T, int L,
    int W, int S, int C, int prime_len, int deterministic, void* stream) {
  if (B < 1 || T < 1 || L < 1 || W < 1 || W > 32 || S % 4 != 0 ||
      C % 3 != 0 || C > MAX_C || (prime_len > 0 && primed == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{lc_proj, w_tap, w_res_t, b_res, front_t, w_skip, skip_bias,
           post1, b1, post2_t, b2, dil, primed, noise, ring, out,
           seed, ring_stride, B, T, L, W, S, C, prime_len, deterministic};
  const size_t smem = sizeof(float) * (32 + R + (size_t)L * R + (size_t)L * 2 * D +
                                       (size_t)L * D + 2 * (size_t)S + MAX_C) +
                      sizeof(int) * 2 * (size_t)L;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wavenet_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wavenet_gen_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
