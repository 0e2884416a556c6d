// Hopper kernels of one free-running Tacotron 2 decoder step.
//
// Replaces the JAX package's TPU kernel ops/pallas_decoder.py::_build_kernel
// (one pallas_call running a whole chunk of decoder steps).  This first
// design launches four kernels per step from the Python wrapper
// (ops/fused_decoder.py): prenet, gate_lstm (once per LSTM), lsa_attention
// and head.  The compute type is bfloat16; carries and sums are float32.
// Values are rounded to bfloat16 at the points where the TPU kernel rounds
// them, so the plain PyTorch version in ops/fused_decoder.py can repeat the
// arithmetic.
//
// Bound on the H100: the two gate products dominate (2*B*(K_att+K_gen)*4H
// int8 operations a step).  Here they run with __dp4a on the CUDA cores
// from shared-memory tiles, the gate weights come from L2 every step, and
// every kernel is one launch a step: simple and right first.
//
// Interface: plain extern "C" launchers taking device pointers and a
// cudaStream_t as void*, each returning cudaGetLastError().  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and never with --use_fast_math: the W8A8 row quantization relies on IEEE
// division and rintf to match the plain version bit for bit.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// prenet: n layers of relu(x @ W + b) with the hashed always-on dropout.
// Block: PRENET_ROWS batch rows; threads walk the output columns.
// ---------------------------------------------------------------------------
constexpr int PRENET_ROWS = 4;
constexpr int PRENET_THREADS = 256;

__global__ void prenet_kernel(const float* __restrict__ frame,
                              const __nv_bfloat16* __restrict__ w_all,
                              const float* __restrict__ b_all,
                              float* __restrict__ out,
                              uint8_t* __restrict__ keep_out, int B,
                              int in_dim, int P, int n_layers, uint32_t seed0,
                              uint32_t seed1, int step, uint32_t thresh,
                              float scale, int apply_dropout) {
  extern __shared__ float smem[];
  const int width = in_dim > P ? in_dim : P;
  float* xa = smem;                         // [ROWS][width] layer input
  float* xb = smem + PRENET_ROWS * width;   // [ROWS][width] layer output
  const int row0 = blockIdx.x * PRENET_ROWS;
  for (int i = threadIdx.x; i < PRENET_ROWS * in_dim; i += blockDim.x) {
    const int r = i / in_dim, k = i % in_dim, row = row0 + r;
    xa[r * width + k] = row < B ? frame[(size_t)row * in_dim + k] : 0.0f;
  }
  __syncthreads();
  const __nv_bfloat16* w = w_all;
  const float* bias = b_all;
  int k_dim = in_dim;
  for (int layer = 0; layer < n_layers; ++layer) {
    const uint32_t salt = (uint32_t)(step * n_layers + layer + 1);
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
      float acc[PRENET_ROWS];
#pragma unroll
      for (int r = 0; r < PRENET_ROWS; ++r) acc[r] = 0.0f;
      for (int k = 0; k < k_dim; ++k) {
        const float wv = bf16_at(w, (size_t)k * P + j);
#pragma unroll
        for (int r = 0; r < PRENET_ROWS; ++r)
          acc[r] = fmaf(round_bf16(xa[r * width + k]), wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < PRENET_ROWS; ++r) {
        const int row = row0 + r;
        float y = fmaxf(acc[r] + bias[j], 0.0f);
        if (apply_dropout) {
          const bool keep =
              rand_bits((uint32_t)row, (uint32_t)j, (uint32_t)P, seed0,
                        seed1, salt) < thresh;
          y = keep ? y * scale : 0.0f;
          if (keep_out != nullptr && row < B)
            keep_out[((size_t)layer * B + row) * P + j] = keep ? 1 : 0;
        }
        xb[r * width + j] = y;
      }
    }
    __syncthreads();
    float* t = xa;
    xa = xb;
    xb = t;
    w += (size_t)k_dim * P;
    bias += P;
    k_dim = P;
  }
  for (int i = threadIdx.x; i < PRENET_ROWS * P; i += blockDim.x) {
    const int r = i / P, j = i % P, row = row0 + r;
    if (row < B) out[(size_t)row * P + j] = xa[r * width + j];
  }
}

// ---------------------------------------------------------------------------
// gate_lstm: gates = [s0 | s1 | s2] @ W (+ W8A8 dequant) + b, then the LSTM
// pointwise step and eval zoneout.  W is [4H, Kp] (one row per gate column,
// K contiguous, zero padded to Kp, a multiple of 64).
// Block: G_BM batch rows x G_UN hidden units (4*G_UN gate columns); each
// thread owns 2 rows x 1 unit x 4 gates.
// ---------------------------------------------------------------------------
constexpr int G_BM = 32;
constexpr int G_UN = 16;
constexpr int G_THREADS = 256;
constexpr int G_KW = 16;  // 32-bit words of K per tile

struct Segments {
  const float* s0;
  const float* s1;
  const float* s2;
  int k0, k1, k2;
  __device__ __forceinline__ float at(int row, int k) const {
    float v;
    if (k < k0)
      v = s0[(size_t)row * k0 + k];
    else if (k < k0 + k1)
      v = s1[(size_t)row * k1 + (k - k0)];
    else if (k < k0 + k1 + k2)
      v = s2[(size_t)row * k2 + (k - k0 - k1)];
    else
      v = 0.0f;
    return round_bf16(v);
  }
};

template <bool INT8>
__global__ void __launch_bounds__(G_THREADS)
gate_lstm_kernel(Segments seg, const uint32_t* __restrict__ w,
                 const float* __restrict__ ws, const float* __restrict__ bias,
                 int kp, const float* __restrict__ h_old,
                 const float* __restrict__ c_old, float* __restrict__ h_new,
                 float* __restrict__ c_new, int8_t* __restrict__ q_out, int B,
                 int H, float zh, float zc) {
  __shared__ uint32_t As[G_BM][G_KW];
  __shared__ uint32_t Ws[4 * G_UN][G_KW + 1];
  __shared__ float s_rs[G_BM];
  __shared__ float s_inv[G_BM];
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x * G_UN;
  const int row0 = blockIdx.y * G_BM;
  const int K = seg.k0 + seg.k1 + seg.k2;

  if (INT8) {
    // per-row scale: rs = max(amax, 1e-6) * (1/127), inv = 1/rs (IEEE)
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < G_BM; r += G_THREADS / 32) {
      const int row = row0 + r;
      float m = 0.0f;
      if (row < B)
        for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(seg.at(row, k)));
      m = warp_max(m);
      if (lane == 0) {
        const float rs = __fmul_rn(fmaxf(m, 1e-6f), (float)(1.0 / 127.0));
        s_rs[r] = rs;
        s_inv[r] = __fdiv_rn(1.0f, rs);
      }
    }
    __syncthreads();
  }

  const int rp = tid / G_UN;  // row pair
  const int u = tid % G_UN;
  int iacc[2][4];
  float facc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      iacc[i][g] = 0;
      facc[i][g] = 0.0f;
    }
  constexpr int PER_WORD = INT8 ? 4 : 2;
  const int words_per_row = kp / PER_WORD;

  for (int kw0 = 0; kw0 < words_per_row; kw0 += G_KW) {
    for (int i = tid; i < G_BM * G_KW; i += G_THREADS) {
      const int r = i / G_KW, wd = i % G_KW, row = row0 + r;
      const int kb = (kw0 + wd) * PER_WORD;
      if (INT8) {
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int q = 0;
          if (row < B) {
            float qf = rintf(__fmul_rn(seg.at(row, kb + j), s_inv[r]));
            q = (int)fminf(fmaxf(qf, -127.0f), 127.0f);
            if (q_out != nullptr && blockIdx.x == 0 && kb + j < K)
              q_out[(size_t)row * K + kb + j] = (int8_t)q;
          }
          packed |= ((uint32_t)(uint8_t)(int8_t)q) << (8 * j);
        }
        As[r][wd] = packed;
      } else {
        float x0 = 0.0f, x1 = 0.0f;
        if (row < B) {
          x0 = seg.at(row, kb);
          x1 = seg.at(row, kb + 1);
        }
        __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
        As[r][wd] = *reinterpret_cast<uint32_t*>(&p);
      }
    }
    for (int i = tid; i < 4 * G_UN * G_KW; i += G_THREADS) {
      const int c = i / G_KW, wd = i % G_KW;
      const int gate = c / G_UN, unit = unit0 + c % G_UN;
      Ws[c][wd] = unit < H
                      ? w[(size_t)(gate * H + unit) * words_per_row + kw0 + wd]
                      : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int wd = 0; wd < G_KW; ++wd) {
      const uint32_t a0 = As[2 * rp][wd], a1 = As[2 * rp + 1][wd];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint32_t wv = Ws[g * G_UN + u][wd];
        if (INT8) {
          iacc[0][g] = __dp4a((int)a0, (int)wv, iacc[0][g]);
          iacc[1][g] = __dp4a((int)a1, (int)wv, iacc[1][g]);
        } else {
          const float2 wf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&wv));
          const float2 f0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a0));
          const float2 f1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a1));
          facc[0][g] = fmaf(f0.y, wf.y, fmaf(f0.x, wf.x, facc[0][g]));
          facc[1][g] = fmaf(f1.y, wf.y, fmaf(f1.x, wf.x, facc[1][g]));
        }
      }
    }
    __syncthreads();
  }

  const int unit = unit0 + u;
  if (unit >= H) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * rp + i, row = row0 + r;
    if (row >= B) continue;
    float gt[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int n = g * H + unit;
      // W8A8 dequant in the TPU kernel's order: ((acc * rs) * ws) + b
      gt[g] = INT8 ? __fadd_rn(__fmul_rn(__fmul_rn((float)iacc[i][g], s_rs[r]),
                                         ws[n]),
                               bias[n])
                   : facc[i][g] + bias[n];
    }
    const size_t o = (size_t)row * H + unit;
    const float c_prev = c_old[o], h_prev = h_old[o];
    const float cn = sigmoid(gt[1]) * c_prev + sigmoid(gt[0]) * tanhf(gt[2]);
    const float hn = sigmoid(gt[3]) * tanhf(cn);
    h_new[o] = zh == 0.0f ? hn : zh * h_prev + (1.0f - zh) * hn;
    c_new[o] = zc == 0.0f ? cn : zc * c_prev + (1.0f - zc) * cn;
  }
}

// ---------------------------------------------------------------------------
// lsa_attention: one block per batch row.
//   q = bf16(h_att @ Wq); loc[t,a] = bf16(sum_k bf16(cum[t+k-half]) lc[k,a])
//   z = bf16(bf16(loc + q) + mtb); e[t] = sum_a v[a] bf16(tanh(z)) + mask
//   w = softmax(e); cum' = cum + w; ctx[m] = sum_t bf16(mem[t,m] bf16(w[t]))
// ---------------------------------------------------------------------------
constexpr int ATT_THREADS = 256;

__global__ void __launch_bounds__(ATT_THREADS)
lsa_attention_kernel(const float* __restrict__ h_att,
                     const float* __restrict__ cum,
                     const __nv_bfloat16* __restrict__ memory,
                     const __nv_bfloat16* __restrict__ mtb,
                     const float* __restrict__ mask_add,
                     const __nv_bfloat16* __restrict__ wq,
                     const __nv_bfloat16* __restrict__ lc,
                     const float* __restrict__ v, float* __restrict__ ctx_out,
                     float* __restrict__ cum_out, int T, int H, int A, int M,
                     int K) {
  extern __shared__ float sm[];
  const int parts = ATT_THREADS / A > 0 ? ATT_THREADS / A : 1;
  float* s_h = sm;                         // H
  float* s_part = s_h + H;                 // parts * A
  float* s_q = s_part + parts * A;         // A
  float* s_cum = s_q + A;                  // T + K - 1, zero padded
  float* s_lc = s_cum + T + K - 1;         // K * A
  float* s_v = s_lc + K * A;               // A
  float* s_e = s_v + A;                    // T
  float* s_red = s_e + T;                  // 32
  const int b = blockIdx.x, tid = threadIdx.x;
  const int half = (K - 1) / 2;

  for (int k = tid; k < H; k += blockDim.x)
    s_h[k] = round_bf16(h_att[(size_t)b * H + k]);
  for (int i = tid; i < T + K - 1; i += blockDim.x) {
    const int t = i - half;
    s_cum[i] = (t >= 0 && t < T) ? round_bf16(cum[(size_t)b * T + t]) : 0.0f;
  }
  for (int i = tid; i < K * A; i += blockDim.x) s_lc[i] = bf16_at(lc, i);
  for (int a = tid; a < A; a += blockDim.x) s_v[a] = v[a];
  __syncthreads();

  // query product, split over `parts` slices of H, summed in a fixed order
  for (int idx = tid; idx < parts * A; idx += blockDim.x) {
    const int a = idx % A, part = idx / A;
    float acc = 0.0f;
    for (int k = part; k < H; k += parts)
      acc = fmaf(s_h[k], bf16_at(wq, (size_t)k * A + a), acc);
    s_part[idx] = acc;
  }
  __syncthreads();
  for (int a = tid; a < A; a += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < parts; ++p) acc += s_part[p * A + a];
    s_q[a] = round_bf16(acc);
  }
  __syncthreads();

  // energies: one warp per text position
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int t = warp; t < T; t += n_warps) {
    float part = 0.0f;
    for (int a = lane; a < A; a += 32) {
      float loc = 0.0f;
      for (int k = 0; k < K; ++k) loc = fmaf(s_cum[t + k], s_lc[k * A + a], loc);
      const float z = round_bf16(round_bf16(round_bf16(loc) + s_q[a]) +
                                 bf16_at(mtb, ((size_t)b * T + t) * A + a));
      part = fmaf(s_v[a], round_bf16(tanhf(z)), part);
    }
    part = warp_sum(part);
    if (lane == 0) s_e[t] = part + mask_add[(size_t)b * T + t];
  }
  __syncthreads();

  // masked softmax, cum update
  float m = -CUDART_INF_F;
  for (int t = tid; t < T; t += blockDim.x) m = fmaxf(m, s_e[t]);
  m = block_reduce<true>(m, s_red);
  float s = 0.0f;
  for (int t = tid; t < T; t += blockDim.x) {
    const float p = expf(s_e[t] - m);
    s_e[t] = p;
    s += p;
  }
  __syncthreads();
  s = block_reduce<false>(s, s_red);
  for (int t = tid; t < T; t += blockDim.x) {
    const float wt = s_e[t] / s;
    cum_out[(size_t)b * T + t] = cum[(size_t)b * T + t] + wt;
    s_e[t] = round_bf16(wt);
  }
  __syncthreads();

  // context
  for (int mm = tid; mm < M; mm += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < T; ++t)
      acc += round_bf16(bf16_at(memory, ((size_t)b * T + t) * M + mm) * s_e[t]);
    ctx_out[(size_t)b * M + mm] = acc;
  }
}

// ---------------------------------------------------------------------------
// head: [h_gen | ctx] @ W_head + b -> frame (first N-1 columns) and stop.
// Block: HEAD_ROWS batch rows; threads walk the output columns.
// ---------------------------------------------------------------------------
constexpr int HEAD_ROWS = 4;
constexpr int HEAD_THREADS = 128;

__global__ void head_kernel(const float* __restrict__ h_gen,
                            const float* __restrict__ ctx,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias,
                            float* __restrict__ frame, float* __restrict__ stop,
                            int B, int H, int M, int N) {
  extern __shared__ float s_x[];  // [HEAD_ROWS][H + M]
  const int K = H + M;
  const int row0 = blockIdx.x * HEAD_ROWS;
  for (int i = threadIdx.x; i < HEAD_ROWS * K; i += blockDim.x) {
    const int r = i / K, k = i % K, row = row0 + r;
    float x = 0.0f;
    if (row < B)
      x = k < H ? h_gen[(size_t)row * H + k] : ctx[(size_t)row * M + k - H];
    s_x[i] = round_bf16(x);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc[HEAD_ROWS];
#pragma unroll
    for (int r = 0; r < HEAD_ROWS; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wv = bf16_at(w, (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < HEAD_ROWS; ++r) acc[r] = fmaf(s_x[r * K + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < HEAD_ROWS; ++r) {
      const int row = row0 + r;
      if (row >= B) continue;
      const float y = acc[r] + bias[n];
      if (n < N - 1)
        frame[(size_t)row * (N - 1) + n] = y;
      else
        stop[row] = y;
    }
  }
}

}  // namespace

extern "C" {

int prenet_launch(const void* frame, const void* w_all, const void* b_all,
                  void* out, void* keep_out, int B, int in_dim, int P,
                  int n_layers, unsigned seed0, unsigned seed1, int step,
                  unsigned thresh, float scale, int apply_dropout,
                  void* stream) {
  const int width = in_dim > P ? in_dim : P;
  const size_t smem = 2 * PRENET_ROWS * width * sizeof(float);
  cudaError_t err = allow_smem(prenet_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + PRENET_ROWS - 1) / PRENET_ROWS;
  prenet_kernel<<<grid, PRENET_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)frame, (const __nv_bfloat16*)w_all, (const float*)b_all,
      (float*)out, (uint8_t*)keep_out, B, in_dim, P, n_layers, seed0, seed1,
      step, thresh, scale, apply_dropout);
  return (int)cudaGetLastError();
}

int gate_lstm_launch(const void* s0, int k0, const void* s1, int k1,
                     const void* s2, int k2, const void* w, const void* ws,
                     const void* bias, int kp, int quantized,
                     const void* h_old, const void* c_old, void* h_new,
                     void* c_new, void* q_out, int B, int H, float zh,
                     float zc, void* stream) {
  if (kp % 64 != 0 || kp < k0 + k1 + k2) return (int)cudaErrorInvalidValue;
  Segments seg{(const float*)s0, (const float*)s1, (const float*)s2,
               k0, k1, k2};
  dim3 grid((H + G_UN - 1) / G_UN, (B + G_BM - 1) / G_BM);
  if (quantized)
    gate_lstm_kernel<true><<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(
        seg, (const uint32_t*)w, (const float*)ws, (const float*)bias, kp,
        (const float*)h_old, (const float*)c_old, (float*)h_new,
        (float*)c_new, (int8_t*)q_out, B, H, zh, zc);
  else
    gate_lstm_kernel<false><<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(
        seg, (const uint32_t*)w, nullptr, (const float*)bias, kp,
        (const float*)h_old, (const float*)c_old, (float*)h_new,
        (float*)c_new, nullptr, B, H, zh, zc);
  return (int)cudaGetLastError();
}

int lsa_attention_launch(const void* h_att, const void* cum,
                         const void* memory, const void* mtb,
                         const void* mask_add, const void* wq, const void* lc,
                         const void* v, void* ctx_out, void* cum_out, int B,
                         int T, int H, int A, int M, int K, void* stream) {
  const int parts = ATT_THREADS / A > 0 ? ATT_THREADS / A : 1;
  const size_t smem =
      (size_t)(H + parts * A + A + (T + K - 1) + K * A + A + T + 32) *
      sizeof(float);
  cudaError_t err = allow_smem(lsa_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lsa_attention_kernel<<<B, ATT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)h_att, (const float*)cum, (const __nv_bfloat16*)memory,
      (const __nv_bfloat16*)mtb, (const float*)mask_add,
      (const __nv_bfloat16*)wq, (const __nv_bfloat16*)lc, (const float*)v,
      (float*)ctx_out, (float*)cum_out, T, H, A, M, K);
  return (int)cudaGetLastError();
}

int head_launch(const void* h_gen, const void* ctx, const void* w,
                const void* bias, void* frame, void* stop, int B, int H,
                int M, int N, void* stream) {
  const size_t smem = (size_t)HEAD_ROWS * (H + M) * sizeof(float);
  cudaError_t err = allow_smem(head_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + HEAD_ROWS - 1) / HEAD_ROWS;
  head_kernel<<<grid, HEAD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)h_gen, (const float*)ctx, (const __nv_bfloat16*)w,
      (const float*)bias, (float*)frame, (float*)stop, B, H, M, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
