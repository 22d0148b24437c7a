// Fused tree-level histogram -> split scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of shifu_tpu/ops/hist_pallas.py
// (`_build_call`, whose `pl.pallas_call` sits at :526), reached through
// `make_pallas_hist_fn` (histogram only) and `make_fused_level_fn`
// (histogram + split scan), in both of its modes:
//
//   moment mode (regression / binary, n_classes < 3), P = 3 planes
//     hist[c, l, t] = sum_i comps[i, c] * [node_i == l] * [off[f(t)] +
//                     clip(code[i, f(t)]) == t]        c in (w, w*y, w*y^2)
//   class mode (NATIVE multi-class, n_classes = K >= 3), P = K planes
//     hist[c, l, t] = sum_i w_i * [cls_i == c] * [node_i == l] * [...]
//     (hist_pallas.py:358-365, :540-552: one weighted count plane a class)
//
// The kernel keeps that kernel's OUTPUT contract, not its TPU layout (no
// 128-lane padding, no [W, W] indicator matmul, no selection matmul). In
// scan mode it computes, per (node l, feature segment f), the stable lex
// rank of every slot on (key, slot index), the inclusive left sums in
// rank order, right = total - left, the gain, the validity mask, and the
// node totals from segment 0. Moment mode: key = mean label, gain by
// variance / friedmanmse / entropy / gini. Class mode (hist_pallas.py:
// 408-430): key = sum_c c*h_c / sum_c h_c, gain = the K-class gini or
// entropy mass drop, class terms summed c = 0..K-1 in order;
// variance/friedmanmse fall back to gini, as in the JAX package.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): the level moves
// n*F code bytes (int8 when every feature fits 128 slots, else int32),
// n*3 comps (bf16 for GBT, f32 for RF) or n class ids + n weights, and n
// int32 node ids, and writes the [P, L, T] f32 histogram (+ three
// [L, T] planes and [L, P] totals in scan mode). It does ~P adds per
// (row, feature) at most, so it is bound by bytes: ~20.5 MB, ~6 us, for
// the bench `gbt` level (n = 500k, F = 30, 33 slots).
//
// Design and how it relates to that bound:
//  * Determinism first. GBT moment planes are floats and two runs must
//    give bit-equal forests, so no float atomics anywhere. Each plane is
//    accumulated in 64-bit FIXED POINT: v -> llrint(v * 2^S_c) with
//    S_c = 61 - ceil(log2(n * max|comp_c|)), so no bin can overflow
//    (class mode: one shift for all K planes, from max|w|). Integer
//    addition is associative, so the shared-memory and the global
//    atomics give the same bits in any order. Integer-valued planes
//    (counts, RF Poisson weights, 0/1 labels) are exact, so RF and
//    multi-class histograms equal the plain f32 sum bit for bit.
//  * hist_accumulate_kernel / hist_accumulate_cls_kernel: grid (row
//    splits, tiles). A tile is a flat slot range x node range sized to
//    3 x 8192 int64 bins over all planes (192 KiB of shared memory), so
//    a class-mode tile holds floor(3 * 8192 / K) bins a plane. Threads
//    walk (row, feature) pairs of their block's rows in row-major order,
//    so code reads are coalesced; rows whose weight is 0 (inactive) or
//    whose node lies outside the tile skip. Moment mode does 3 shared
//    atomics per (row, feature); class mode one, into the row's class
//    plane (a row adds its weight to exactly one class). At the end each
//    nonzero shared bin is added once to the global int64 accumulator.
//    Codes are read once per node tile (the whole int8 matrix of the
//    bench shapes sits in the 50 MB L2).
//  * hist_finalize_kernel: grid (features, nodes). Converts the int64
//    accumulator to the f32 histogram and, in scan mode, scans the
//    segment in dynamic shared memory ((2P + 3) * 4 bytes a slot):
//    pairwise stable rank (O(size^2), exact ties), prefix sums in rank
//    order, gains. Segments wider than the wrapper's seg_cap (SEG_CAP,
//    or less where K planes of a 1,024-slot segment do not fit the
//    block's shared memory) are left to the wrapper's torch scan.
//  * Built with -fmad=false so the gain arithmetic rounds like the
//    separate elementwise ops of the plain PyTorch version; the class
//    scan uses explicit fmaf where the JAX package's XLA scan contracts
//    a multiply-add (the plain version's `fma32`). Gini gains on integer
//    planes are bit-equal; log2f may differ by an ulp from the CPU's
//    log2, so entropy gains agree to a tolerance.
//
// Plain C interface, loaded with ctypes (shifu_tpu_torch/ops/build.py).
// Each launcher returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#define ACC_THREADS 512
#define SCAN_THREADS 256
#define SEG_CAP 1024

namespace {

__device__ __forceinline__ int plane_shift(float maxabs, int n) {
  // every bin sum is bounded by n * max|v| < 2^e, so sums scaled by
  // 2^(61 - e) stay below 2^61 (headroom for per-element rounding)
  int e = 0;
  frexp((double)maxabs * (double)n, &e);
  return 61 - e;
}

__device__ __forceinline__ float load_comp(const float* p) { return *p; }
__device__ __forceinline__ float load_comp(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename CodeT, typename CompT>
__global__ void __launch_bounds__(ACC_THREADS)
hist_accumulate_kernel(const CodeT* __restrict__ codes,
                       const CompT* __restrict__ comps,
                       const int* __restrict__ node, int n, int F, int T,
                       int L, const int* __restrict__ off,
                       const int* __restrict__ clip,
                       const int* __restrict__ tiles, int rows_per_split,
                       const float* __restrict__ maxabs,
                       unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sh[];
  const int* tp = tiles + 6 * blockIdx.y;
  const int f_lo = tp[0], f_hi = tp[1], t_lo = tp[2], t_w = tp[3];
  const int l_lo = tp[4], l_n = tp[5];
  const int nbins = l_n * t_w;
  for (int i = threadIdx.x; i < 3 * nbins; i += blockDim.x) sh[i] = 0ull;
  const double s0 = ldexp(1.0, plane_shift(maxabs[0], n));
  const double s1 = ldexp(1.0, plane_shift(maxabs[1], n));
  const double s2 = ldexp(1.0, plane_shift(maxabs[2], n));
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_split;
  const long long r1 = min((long long)n, r0 + rows_per_split);
  const int nf = f_hi - f_lo;
  const int total = r0 < r1 ? (int)(r1 - r0) * nf : 0;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const long long i = r0 + j / nf;
    const int f = f_lo + j % nf;
    const int l = node[i] - l_lo;
    if ((unsigned)l >= (unsigned)l_n) continue;
    const CompT* cp = comps + 3 * i;
    const float v0 = load_comp(cp), v1 = load_comp(cp + 1),
                v2 = load_comp(cp + 2);
    if (v0 == 0.f && v1 == 0.f && v2 == 0.f) continue;  // inactive row
    int code = (int)codes[i * F + f];
    code = min(max(code, 0), clip[f]);
    const int t = off[f] + code - t_lo;
    if ((unsigned)t >= (unsigned)t_w) continue;
    const int b = l * t_w + t;
    const long long q0 = llrint((double)v0 * s0);
    const long long q1 = llrint((double)v1 * s1);
    const long long q2 = llrint((double)v2 * s2);
    if (q0) atomicAdd(&sh[b], (unsigned long long)q0);
    if (q1) atomicAdd(&sh[nbins + b], (unsigned long long)q1);
    if (q2) atomicAdd(&sh[2 * nbins + b], (unsigned long long)q2);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * nbins; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int c = i / nbins, b = i % nbins;
    const int l = l_lo + b / t_w, t = t_lo + b % t_w;
    atomicAdd(&acc[((size_t)c * L + l) * T + t], v);
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(ACC_THREADS)
hist_accumulate_cls_kernel(const CodeT* __restrict__ codes,
                           const int* __restrict__ cls,
                           const float* __restrict__ w,
                           const int* __restrict__ node, int n, int F,
                           int T, int L, int K, const int* __restrict__ off,
                           const int* __restrict__ clip,
                           const int* __restrict__ tiles, int rows_per_split,
                           const float* __restrict__ maxabs,
                           unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sh[];
  const int* tp = tiles + 6 * blockIdx.y;
  const int f_lo = tp[0], f_hi = tp[1], t_lo = tp[2], t_w = tp[3];
  const int l_lo = tp[4], l_n = tp[5];
  const int nbins = l_n * t_w;
  for (int i = threadIdx.x; i < K * nbins; i += blockDim.x) sh[i] = 0ull;
  const double s = ldexp(1.0, plane_shift(maxabs[0], n));
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_split;
  const long long r1 = min((long long)n, r0 + rows_per_split);
  const int nf = f_hi - f_lo;
  const int total = r0 < r1 ? (int)(r1 - r0) * nf : 0;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const long long i = r0 + j / nf;
    const int f = f_lo + j % nf;
    const int l = node[i] - l_lo;
    if ((unsigned)l >= (unsigned)l_n) continue;
    const float v = w[i];
    if (v == 0.f) continue;  // inactive row
    int code = (int)codes[i * F + f];
    code = min(max(code, 0), clip[f]);
    const int t = off[f] + code - t_lo;
    if ((unsigned)t >= (unsigned)t_w) continue;
    const long long q = llrint((double)v * s);
    if (q) atomicAdd(&sh[cls[i] * nbins + l * t_w + t],
                     (unsigned long long)q);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * nbins; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int c = i / nbins, b = i % nbins;
    const int l = l_lo + b / t_w, t = t_lo + b % t_w;
    atomicAdd(&acc[((size_t)c * L + l) * T + t], v);
  }
}

__device__ __forceinline__ float sse(float c, float s, float q) {
  return q - (s * s) / fmaxf(c, 1e-12f);
}

__device__ __forceinline__ float gini_mass(float c, float p) {
  const float ng = c - p;
  return c - (p * p + ng * ng) / fmaxf(c, 1e-12f);
}

__device__ __forceinline__ float entropy_mass(float c, float p) {
  const float pr = p / fmaxf(c, 1e-12f);
  const float q = 1.f - pr;
  const float h = -(pr * log2f(fmaxf(pr, 1e-12f))
                    + q * log2f(fmaxf(q, 1e-12f)));
  return c * h;
}

// impurity: 0 variance, 1 friedmanmse, 2 entropy, 3 gini
__device__ __forceinline__ float split_gain(int impurity, float lc, float ls1,
                                            float ls2, float rc, float rs1,
                                            float rs2, float tc, float ts1,
                                            float ts2) {
  if (impurity == 2)
    return entropy_mass(tc, ts1) - entropy_mass(lc, ls1)
           - entropy_mass(rc, rs1);
  if (impurity == 3)
    return gini_mass(tc, ts1) - gini_mass(lc, ls1) - gini_mass(rc, rs1);
  if (impurity == 1) {
    const float ml = ls1 / fmaxf(lc, 1e-12f);
    const float mr = rs1 / fmaxf(rc, 1e-12f);
    const float d = ml - mr;
    return (lc * rc) / fmaxf(tc, 1e-12f) * (d * d);
  }
  return sse(tc, ts1, ts2) - sse(lc, ls1, ls2) - sse(rc, rs1, rs2);
}

// K-class impurity of one side (hist_pallas.py:416-427): part 0 = left
// (pre[c][r]), 1 = right (total - left), 2 = the segment total. gini
// 1 - sum_c p_c^2, entropy -sum_c p_c log2 p_c, class terms summed
// c = 0..K-1 in order, each a fused multiply-add onto the running sum
// (fmaf is fused even under -fmad=false): the rounding of the JAX
// package's XLA scan on the CPU, which the plain version reproduces
// (`tree_trainer.fma32`).
__device__ __forceinline__ float class_impurity(const float* pre, int cap,
                                                int K, int r, int last,
                                                int part, float total,
                                                bool entropy) {
  const float den = fmaxf(total, 1e-12f);
  float acc = 0.f;
  for (int c = 0; c < K; ++c) {
    const float* pc = pre + (size_t)c * cap;
    const float x = part == 0 ? pc[r]
                    : part == 1 ? pc[last] - pc[r] : pc[last];
    const float p = x / den;
    acc = fmaf(p, entropy ? log2f(fmaxf(p, 1e-12f)) : p, acc);
  }
  return entropy ? -acc : 1.f - acc;
}

// Dynamic shared memory, in floats of seg_cap slots: h [P][cap], pre
// [P][cap], key [cap], then ints order [cap], rnk [cap].
__global__ void __launch_bounds__(SCAN_THREADS)
hist_finalize_kernel(const unsigned long long* __restrict__ acc,
                     const float* __restrict__ maxabs, int n, int L, int T,
                     int P, int cls_mode, int seg_cap,
                     const int* __restrict__ off,
                     const int* __restrict__ slots,
                     const int* __restrict__ is_cat,
                     const float* __restrict__ featok, int do_scan,
                     int impurity, float min_inst, float min_gain,
                     float* __restrict__ hist, float* __restrict__ gain,
                     int* __restrict__ rank, float* __restrict__ lcnt,
                     float* __restrict__ tot0) {
  extern __shared__ float smem[];
  const int cap = seg_cap;
  float* h = smem;
  float* pre = h + (size_t)P * cap;
  float* key = pre + (size_t)P * cap;
  int* order = (int*)(key + cap);
  int* rnk = order + cap;

  const int f = blockIdx.x, l = blockIdx.y;
  const int start = off[f], size = slots[f];
  const int tid = threadIdx.x, bd = blockDim.x;
  const bool fits = do_scan && size <= cap;
  // class planes share one fixed-point shift (from max|w|)
  const double inv0 = ldexp(1.0, -plane_shift(maxabs[0], n));

  for (int s = tid; s < size; s += bd) {
    const size_t t = (size_t)start + s;
    for (int c = 0; c < P; ++c) {
      const double inv = (cls_mode || c == 0)
                             ? inv0 : ldexp(1.0, -plane_shift(maxabs[c], n));
      const size_t k = ((size_t)c * L + l) * T + t;
      const float v = (float)((double)(long long)acc[k] * inv);
      hist[k] = v;
      if (fits) h[(size_t)c * cap + s] = v;
    }
  }
  if (!do_scan) return;
  const size_t row = (size_t)l * T + start;

  if (!fits) {  // the wrapper's torch split scan owns this segment
    for (int s = tid; s < size; s += bd) {
      gain[row + s] = -CUDART_INF_F;
      rank[row + s] = s;
      lcnt[row + s] = 0.f;
    }
    if (f == 0) {
      __syncthreads();  // this block's hist writes are visible after it
      for (int c = tid; c < P; c += bd) {
        float run = 0.f;
        for (int s = 0; s < size; ++s)
          run += hist[((size_t)c * L + l) * T + start + s];
        tot0[l * P + c] = run;
      }
    }
    return;
  }
  __syncthreads();

  const bool cat = is_cat[f] != 0;
  for (int s = tid; s < size; s += bd) {
    // categorical segments sort by mean label (class mode: by expected
    // class index sum_c c*h_c / sum_c h_c), empty slots last (+inf);
    // numeric segments keep slot order
    float k = (float)s;
    if (cat) {
      float cnt, num;
      if (cls_mode) {
        cnt = h[s];
        for (int c = 1; c < P; ++c) cnt = cnt + h[(size_t)c * cap + s];
        num = 0.f;
        for (int c = 0; c < P; ++c)
          num = num + (float)c * h[(size_t)c * cap + s];
      } else {
        cnt = h[s];
        num = h[cap + s];
      }
      k = cnt > 0.f ? num / fmaxf(cnt, 1e-12f) : CUDART_INF_F;
    }
    key[s] = k;
  }
  __syncthreads();
  // stable lex rank on (key, slot): equals a stable sort's position
  for (int a = tid; a < size; a += bd) {
    const float ka = key[a];
    int r = 0;
    for (int b = 0; b < size; ++b) {
      const float kb = key[b];
      r += (kb < ka) || (kb == ka && b < a);
    }
    rnk[a] = r;
    order[r] = a;
  }
  __syncthreads();
  // inclusive prefix sums in rank order, one plane a lane
  for (int c = tid; c < P; c += bd) {
    const float* hc = h + (size_t)c * cap;
    float* pc = pre + (size_t)c * cap;
    float run = 0.f;
    for (int r = 0; r < size; ++r) {
      run += hc[order[r]];
      pc[r] = run;
    }
  }
  __syncthreads();

  const int last = size - 1;
  const bool entropy = impurity == 2;
  for (int a = tid; a < size; a += bd) {
    const int r = rnk[a];
    float lc, rc, g;
    if (cls_mode) {
      lc = pre[r];
      rc = pre[last] - pre[r];
      for (int c = 1; c < P; ++c) {
        const float* pc = pre + (size_t)c * cap;
        lc = lc + pc[r];
        rc = rc + (pc[last] - pc[r]);
      }
      const float tc = lc + rc;
      // tc*h_tot - lc*h_left - rc*h_right, contracted as the XLA scan
      const float hl = class_impurity(pre, cap, P, r, last, 0, lc, entropy);
      const float hr = class_impurity(pre, cap, P, r, last, 1, rc, entropy);
      const float ht = class_impurity(pre, cap, P, r, last, 2, tc, entropy);
      g = fmaf(-rc, hr, fmaf(tc, ht, -(lc * hl)));
    } else {
      const float* p1 = pre + cap;
      const float* p2 = pre + 2 * (size_t)cap;
      const float tc = pre[last], ts1 = p1[last], ts2 = p2[last];
      lc = pre[r];
      const float ls1 = p1[r], ls2 = p2[r];
      rc = tc - lc;
      const float rs1 = ts1 - ls1, rs2 = ts2 - ls2;
      g = split_gain(impurity, lc, ls1, ls2, rc, rs1, rs2, tc, ts1, ts2);
    }
    const bool valid = (lc >= min_inst) && (rc >= min_inst) && (g > min_gain)
                       && (featok[start + a] > 0.f) && (r < last);
    gain[row + a] = valid ? g : -CUDART_INF_F;
    rank[row + a] = r;
    lcnt[row + a] = lc;
  }
  if (f == 0)
    for (int c = tid; c < P; c += bd)
      tot0[l * P + c] = pre[(size_t)c * cap + last];
}

}  // namespace

extern "C" {

// Zero `acc` [3, L, T] int64 and accumulate the level's moment histogram
// into it. tiles: [n_tiles, 6] int32 (f_lo, f_hi, t_lo, t_w, l_lo, l_n),
// device; smem_bins: bins a plane of the largest tile.
int hist_accumulate(const void* codes, int code_is_i8, const void* comps,
                    int comps_is_bf16, const int* node, int n, int F, int T,
                    int L, const int* off, const int* clip, const int* tiles,
                    int n_tiles, int row_splits, int rows_per_split,
                    int smem_bins, const float* maxabs, void* acc,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * 3 * (size_t)L * T, st);
  const size_t smem = sizeof(unsigned long long) * 3 * (size_t)smem_bins;
  const dim3 grid(row_splits, n_tiles);
  unsigned long long* a = (unsigned long long*)acc;
#define LAUNCH(CT, PT)                                                       \
  do {                                                                       \
    cudaFuncSetAttribute(hist_accumulate_kernel<CT, PT>,                     \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)smem);                                         \
    hist_accumulate_kernel<CT, PT><<<grid, ACC_THREADS, smem, st>>>(         \
        (const CT*)codes, (const PT*)comps, node, n, F, T, L, off, clip,     \
        tiles, rows_per_split, maxabs, a);                                   \
  } while (0)
  if (code_is_i8) {
    if (comps_is_bf16) LAUNCH(int8_t, __nv_bfloat16);
    else LAUNCH(int8_t, float);
  } else {
    if (comps_is_bf16) LAUNCH(int32_t, __nv_bfloat16);
    else LAUNCH(int32_t, float);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// Class mode: zero `acc` [K, L, T] int64 and add each active row's weight
// w[i] into plane cls[i] (cls in [0, K); w = 0 on inactive rows).
int hist_accumulate_cls(const void* codes, int code_is_i8, const int* cls,
                        const float* w, const int* node, int n, int F, int T,
                        int L, int K, const int* off, const int* clip,
                        const int* tiles, int n_tiles, int row_splits,
                        int rows_per_split, int smem_bins,
                        const float* maxabs, void* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(acc, 0,
                  sizeof(unsigned long long) * (size_t)K * L * T, st);
  const size_t smem = sizeof(unsigned long long) * (size_t)K * smem_bins;
  const dim3 grid(row_splits, n_tiles);
  unsigned long long* a = (unsigned long long*)acc;
#define LAUNCH(CT)                                                           \
  do {                                                                       \
    cudaFuncSetAttribute(hist_accumulate_cls_kernel<CT>,                     \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)smem);                                         \
    hist_accumulate_cls_kernel<CT><<<grid, ACC_THREADS, smem, st>>>(         \
        (const CT*)codes, cls, w, node, n, F, T, L, K, off, clip, tiles,     \
        rows_per_split, maxabs, a);                                          \
  } while (0)
  if (code_is_i8) LAUNCH(int8_t);
  else LAUNCH(int32_t);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// int64 accumulator [P, L, T] -> f32 hist [P, L, T]; with do_scan also
// gain/rank/lcnt [L, T] and tot0 [L, P]. cls_mode: P = K class planes
// (one shift, from maxabs[0]); else P = 3 moment planes.
int hist_finalize(const void* acc, const float* maxabs, int n, int L, int T,
                  int F, int P, int cls_mode, int seg_cap, const int* off,
                  const int* slots, const int* is_cat, const float* featok,
                  int do_scan, int impurity, float min_inst, float min_gain,
                  float* hist, float* gain, int* rank, float* lcnt,
                  float* tot0, void* stream) {
  if (seg_cap < 1 || seg_cap > SEG_CAP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = do_scan
      ? (2 * (size_t)P + 1) * seg_cap * sizeof(float)
            + 2 * (size_t)seg_cap * sizeof(int)
      : 0;
  cudaFuncSetAttribute(hist_finalize_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(F, L);
  hist_finalize_kernel<<<grid, SCAN_THREADS, smem, st>>>(
      (const unsigned long long*)acc, maxabs, n, L, T, P, cls_mode, seg_cap,
      off, slots, is_cat, featok, do_scan, impurity, min_inst, min_gain,
      hist, gain, rank, lcnt, tot0);
  return (int)cudaGetLastError();
}

int hist_seg_cap(void) { return SEG_CAP; }

// Shared memory a block of the current device may opt in to (bytes).
int hist_smem_optin(void) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

}  // extern "C"
