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
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): a level must read the
// codes of its live rows (active, weight != 0; F bytes a row when every
// feature fits 128 slots, else 4F) and, of every row, the label, weight,
// node id and active flag (13 bytes), and write the [P, L, T] f32
// histogram (+ three [L, T] planes and [L, P] totals in scan mode). It
// does at most P adds per live (row, feature), so it is bound by bytes:
// ~10-20 MB, 3-6 us, at the bench `gbt` and `rf` shapes (n = 500k,
// F = 30).
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
//  * hist_group_kernel, the pre-pass (one cooperative launch, a grid sync
//    in the middle). Per row it does the entry's prep: inactive rows and
//    rows of weight 0 drop out, node ids clamp to [0, L), class ids to
//    [0, K), the moment comps are w, w*y, (w*y)*y as separate f32
//    products and, for GBT, rounded to bf16 as torch rounds them. It
//    takes max|comp| per plane (the fixed-point shift) and counting-sorts
//    the live rows by node group (l_n nodes a group): per-block counts, a
//    grid sync, each group's counts scanned over the blocks by one block,
//    a second grid sync, then a scatter of (row id,
//    node-in-group | class << 16) and the comps into group order. Where
//    there are few groups (L = 1 sends every row to one), the lanes of a
//    warp that share a group count and claim their slots with one shared
//    atomic. It also zeroes the int64 accumulator.
//  * hist_accumulate_kernel. A tile is one node group x one slot range
//    that ends on feature boundaries (only a feature wider than a tile is
//    split), so each live (row, feature) pair falls in one tile and a
//    tile sees only its group's rows: the codes are walked once a level,
//    whatever the number of node tiles, and the rows the subtraction path
//    does not build are never walked. The pairs of all tiles are laid end
//    to end and cut into equal spans, one a block, so a skewed level (one
//    node holding 99% of the rows) still spreads over every SM. A thread
//    takes a row: it loads the row's record and quantizes its values
//    once, reads its codes 16 bytes at a time (int8 rows are padded to 16
//    bytes by codes8_of, so a 30-feature row is one 32-byte sector; int32
//    codes are read one by one, through an L1 that the int32 variants
//    leave at its default size), and adds into the tile's shared bins. (A
//    warp's lanes on one row, each on its own features, spread the adds
//    over more banks but hold 8x fewer rows in flight: slower on the
//    card.) The bins are uint32 where
//    every plane value is an integer (the trainer's `int_planes`: RF and
//    NATIVE RF under integer weights), flushed as v * 2^S into the same
//    int64 accumulator, which is the integer sum of llrint(v * 2^S); else
//    the 64-bit fixed point. A 32-bit block flushes every row_cap rows so no
//    bin can pass 2^31, and a row whose value is not an integer of at most
//    2^24 adds its fixed-point terms to the global accumulator directly,
//    so the 32-bit route is exact for any input. Tiles are sized by the
//    wrapper (`tile_bytes_for`) so that four blocks share an SM, and a
//    block takes at least ACC_PAIRS_PER_BLOCK pairs.
//  * hist_finalize_kernel: grid (features, nodes). Converts the int64
//    accumulator to the f32 histogram and, in scan mode, scans the
//    segment in dynamic shared memory ((2P + 3) * 4 bytes a slot):
//    pairwise stable rank (O(size^2), exact ties), prefix sums in rank
//    order, gains. Segments wider than the wrapper's seg_cap (SEG_CAP,
//    or less where K planes of a 1,024-slot segment do not fit the
//    block's shared memory) are left to the wrapper's torch scan.
//  * Built with -fmad=false so the comps and the gain arithmetic round
//    like the separate elementwise ops of the plain PyTorch version; the
//    class scan uses explicit fmaf where the JAX package's XLA scan
//    contracts a multiply-add (the plain version's `fma32`). Gini gains on
//    integer planes are bit-equal; log2f may differ by an ulp from the
//    CPU's log2, so entropy gains agree to a tolerance.
//
// Plain C interface, loaded with ctypes (shifu_tpu_torch/ops/build.py).
// Each launcher returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

#define PRE_THREADS 512
#define ACC_THREADS 256
#define ACC_MIN_BLOCKS 4
// fewest (row, feature) pairs worth an accumulate block of its own
#define ACC_PAIRS_PER_BLOCK 16384
#define SCAN_THREADS 256
#define SEG_CAP 1024
// fewest rows worth a pre-pass block
#define PRE_ROWS_MIN 2048
// most node groups whose rows the pre-pass counts with warp-wide atomics
#define AGG_GROUPS 4
// largest |value| a row adds to a 32-bit shared bin (2^24)
#define INT32_VMAX 16777216.f

namespace {

__device__ __forceinline__ int plane_shift(float maxabs, int n) {
  // every bin sum is bounded by n * max|v| < 2^e, so sums scaled by
  // 2^(61 - e) stay below 2^61 (headroom for per-element rounding)
  int e = 0;
  frexp((double)maxabs * (double)n, &e);
  return 61 - e;
}

__device__ __forceinline__ int clamp_node(long long v, int L) {
  return (int)(v < 0 ? 0 : (v >= L ? L - 1 : v));
}

// The entry's prep of row i. False for a dead row (inactive, or weight 0);
// else its plane values v (moment: w, w*y, (w*y)*y as separate f32
// products, bf16-rounded for GBT; class: w) and its class id.
template <bool CLS, bool LOWP>
__device__ __forceinline__ bool row_prep(const float* __restrict__ labels,
                                         const float* __restrict__ weights,
                                         const unsigned char* __restrict__ active,
                                         long long i, int K, float* v,
                                         int& cls) {
  const float w = active[i] ? weights[i] : 0.f;
  if (w == 0.f) return false;
  const float y = labels[i];
  cls = 0;
  v[0] = w;
  if constexpr (CLS) {
    // torch's float -> int32 cast (truncation), then the clamp
    cls = min(max(__float2int_rz(y), 0), K - 1);
  } else {
    const float wy = w * y;
    v[1] = wy;
    v[2] = wy * y;
    if constexpr (LOWP) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        v[j] = __bfloat162float(__float2bfloat16_rn(v[j]));
    }
  }
  return true;
}

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// In-place exclusive prefix sum of a[0, m) in shared memory; returns the
// total. Every thread of the block calls it.
__device__ int block_exclusive_scan(int* a, int m, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + tid;
    const int x = i < m ? a[i] : 0;
    int s = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane == 31) wsum[wid] = s;
    __syncthreads();
    if (wid == 0) {
      int ws = lane < nw ? wsum[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, ws, o);
        if (lane >= o) ws += y;
      }
      if (lane < nw) wsum[lane] = ws;
    }
    __syncthreads();
    if (i < m) a[i] = carry + (wid ? wsum[wid - 1] : 0) + s - x;
    carry += wsum[nw - 1];
    __syncthreads();
  }
  return carry;
}

// The pre-pass. Rows split into one contiguous range a block; dynamic
// shared memory holds 2 * n_groups + gridDim.x ints. Outputs: gstart
// [n_groups + 1] (live rows before each group), grow [live] (row id,
// node-in-group | class << 16) and gval [live] (w, or the float4 (w, w*y,
// w*y^2, 0)) in group order, maxabs [NV], and acc zeroed. Scratch: part
// / pmax, per-block counts and maxima ([gridDim.x, n_groups],
// [gridDim.x, NV]); gtot [n_groups], the group totals.
template <typename NodeT, bool CLS, bool LOWP>
__global__ void __launch_bounds__(PRE_THREADS)
hist_group_kernel(const float* __restrict__ labels,
                  const float* __restrict__ weights,
                  const NodeT* __restrict__ node,
                  const unsigned char* __restrict__ active, int n, int L,
                  int K, int l_n, int n_groups, int* __restrict__ part,
                  int* __restrict__ gtot, unsigned* __restrict__ pmax,
                  int* __restrict__ gstart,
                  float* __restrict__ maxabs, int2* __restrict__ grow,
                  float* __restrict__ gval,
                  unsigned long long* __restrict__ acc, long long acc_words) {
  constexpr int NV = CLS ? 1 : 3;
  extern __shared__ int sm[];
  int* cnt = sm;             // counts, then group starts
  int* cur = sm + n_groups;  // this block's scatter cursors
  int* col = cur + n_groups; // one group's count in every block
  __shared__ int wsum[PRE_THREADS / 32];
  __shared__ unsigned wmax[NV][PRE_THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, b = blockIdx.x, B = gridDim.x;

  const long long stride = (long long)B * blockDim.x;
  for (long long k = (long long)b * blockDim.x + tid; k < acc_words;
       k += stride)
    acc[k] = 0ull;
  for (int g = tid; g < n_groups; g += blockDim.x) cnt[g] = 0;
  __syncthreads();

  const long long rpb = ((long long)n + B - 1) / B;
  const long long r0 = (long long)b * rpb;
  const long long r1 = min((long long)n, r0 + rpb);
  const int lane = tid & 31;
  const unsigned full = 0xffffffffu;
  // max|v| on the float's bits: non-negative floats order as unsigned,
  // and a NaN comes out on top, as torch's amax gives it
  unsigned mx[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) mx[j] = 0u;
  // the 32 lanes of a warp take 32 neighbouring rows (warp-uniform loop).
  // With few groups (L = 1 sends every row to one) the lanes of a group
  // add their count in one atomic; with many, each lane adds its own (a
  // match over many distinct groups costs more than the atomics)
  const bool agg = n_groups <= AGG_GROUPS;
  for (long long base = r0 + (tid & ~31); base < r1; base += blockDim.x) {
    const long long i = base + lane;
    float v[3];
    int c = 0;
    const bool live =
        i < r1 && row_prep<CLS, LOWP>(labels, weights, active, i, K, v, c);
    const int g = live ? clamp_node((long long)node[i], L) / l_n : -1;
    if (agg) {
      const unsigned same = __match_any_sync(full, g);
      if (live && lane == __ffs(same) - 1) atomicAdd(&cnt[g], __popc(same));
    } else if (live) {
      atomicAdd(&cnt[g], 1);
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        mx[j] = max(mx[j], __float_as_uint(fabsf(v[j])));
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const unsigned m = warp_max(mx[j]);
    if (lane == 0) wmax[j][tid >> 5] = m;
  }
  __syncthreads();
  if (tid < NV) {
    unsigned m = 0u;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) m = max(m, wmax[tid][k]);
    pmax[b * NV + tid] = m;
  }
  for (int g = tid; g < n_groups; g += blockDim.x)
    part[(size_t)b * n_groups + g] = cnt[g];
  grid.sync();

  // block bb scans the per-block counts of groups bb, bb + B, ... (a
  // column of part) into exclusive prefixes in place, and writes the
  // group's total; after the second grid sync each block reads its own
  // row of prefixes and the totals
  for (int g = b; g < n_groups; g += B) {
    for (int k = tid; k < B; k += blockDim.x)
      col[k] = __ldcg(&part[(size_t)k * n_groups + g]);
    __syncthreads();
    const int tot = block_exclusive_scan(col, B, wsum);
    for (int k = tid; k < B; k += blockDim.x)
      part[(size_t)k * n_groups + g] = col[k];
    if (tid == 0) gtot[g] = tot;
    __syncthreads();
  }
  grid.sync();
  for (int g = tid; g < n_groups; g += blockDim.x) {
    cnt[g] = __ldcg(&gtot[g]);
    cur[g] = __ldcg(&part[(size_t)b * n_groups + g]);
  }
  __syncthreads();
  const int live = block_exclusive_scan(cnt, n_groups, wsum);
  for (int g = tid; g < n_groups; g += blockDim.x) cur[g] += cnt[g];
  if (b == 0) {
    for (int g = tid; g < n_groups; g += blockDim.x) gstart[g] = cnt[g];
    if (tid == 0) gstart[n_groups] = live;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unsigned m = 0u;
      for (int bb = tid; bb < B; bb += blockDim.x)
        m = max(m, __ldcg(&pmax[bb * NV + j]));
      m = warp_max(m);
      if (lane == 0) wmax[j][tid >> 5] = m;
    }
    __syncthreads();
    if (tid < NV) {
      unsigned m = 0u;
      for (int k = 0; k < (int)(blockDim.x >> 5); ++k) m = max(m, wmax[tid][k]);
      maxabs[tid] = __uint_as_float(m);
    }
  }
  __syncthreads();

  // the scatter (few groups: a group's lanes take consecutive slots from
  // one atomic); order inside a group does not matter (integer sums)
  for (long long base = r0 + (tid & ~31); base < r1; base += blockDim.x) {
    const long long i = base + lane;
    float v[3];
    int c = 0;
    const bool live =
        i < r1 && row_prep<CLS, LOWP>(labels, weights, active, i, K, v, c);
    const int nl = live ? clamp_node((long long)node[i], L) : 0;
    const int g = live ? nl / l_n : -1;
    int pos = 0;
    if (agg) {
      const unsigned same = __match_any_sync(full, g);
      const int leader = __ffs(same) - 1;
      if (live && lane == leader) pos = atomicAdd(&cur[g], __popc(same));
      pos = __shfl_sync(full, pos, leader)
            + __popc(same & ((1u << lane) - 1u));
    } else if (live) {
      pos = atomicAdd(&cur[g], 1);
    }
    if (!live) continue;
    grow[pos] = make_int2((int)i, (nl - g * l_n) | (c << 16));
    if constexpr (CLS)
      gval[pos] = v[0];
    else
      reinterpret_cast<float4*>(gval)[pos] = make_float4(v[0], v[1], v[2],
                                                         0.f);
  }
}

// The accumulate. ttile [n_tt, 5]: (f_lo, f_hi, t_lo, t_w, features of
// the slot ranges before it); NF = all features. Tile (g, tt) owns pair
// positions [gstart[g] * NF + cnt_g * ttile[tt][4], + cnt_g * nf_tt);
// block b takes pair positions [b * W / B, (b + 1) * W / B) of the
// W = live * NF, a row going with its first pair. Dynamic shared memory:
// the tile's feature table (tab_bytes), then P * l_n * max t_w bins.
template <typename CodeT, bool CLS, typename BinT>
__global__ void __launch_bounds__(ACC_THREADS, ACC_MIN_BLOCKS)
hist_accumulate_kernel(const CodeT* __restrict__ codes,
                       long long code_stride, const int2* __restrict__ grow,
                       const float* __restrict__ gval,
                       const int* __restrict__ gstart, int n_groups, int l_n,
                       const int* __restrict__ ttile, int n_tt, int NF,
                       int tab_bytes, const int* __restrict__ off,
                       const int* __restrict__ clip,
                       const float* __restrict__ maxabs, int n, int L, int T,
                       int K, unsigned long long* __restrict__ acc) {
  constexpr int NV = CLS ? 1 : 3;
  constexpr bool B32 = sizeof(BinT) == 4;
  extern __shared__ __align__(16) unsigned char smraw[];
  int2* tab = reinterpret_cast<int2*>(smraw);
  BinT* bins = reinterpret_cast<BinT*>(smraw + tab_bytes);
  const int P = CLS ? K : 3;
  const int tid = threadIdx.x;

  int S[NV];
  double sc[NV];
  // 32-bit route: v * 2^S is an integer for an integer v when S >= 0
  bool fits32 = B32;
  float vmax = 1.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    S[j] = plane_shift(maxabs[j], n);
    sc[j] = ldexp(1.0, S[j]);
    fits32 = fits32 && S[j] >= 0;
    vmax = fmaxf(vmax, fminf(maxabs[j], INT32_VMAX));
  }
  // rows between two flushes: no 32-bit bin passes 2^31 - 1
  const long long row_cap =
      B32 ? (long long)(2147483647.0 / (double)ceilf(vmax)) : (1LL << 62);

  const long long W = (long long)gstart[n_groups] * NF;
  const long long w0 = W * blockIdx.x / gridDim.x;
  const long long w1 = W * (blockIdx.x + 1) / gridDim.x;
  if (w0 >= w1) return;
  int lo = 0, hi = n_groups - 1;  // the last group starting at or before w0
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((long long)gstart[mid] * NF <= w0) lo = mid;
    else hi = mid - 1;
  }

  for (int g = lo; g < n_groups; ++g) {
    const long long gs = gstart[g];
    const long long cnt = gstart[g + 1] - gs;
    if (gs * NF >= w1) break;
    if (cnt == 0) continue;
    const int l_lo = g * l_n;
    const int lg = min(l_n, L - l_lo);
    for (int tt = 0; tt < n_tt; ++tt) {
      const int* d = ttile + 5 * tt;
      const int f_lo = d[0], f_hi = d[1], t_lo = d[2], t_w = d[3];
      const int nf = f_hi - f_lo;
      const long long ts = gs * NF + cnt * d[4];
      if (ts >= w1) break;
      if (ts + cnt * nf <= w0) continue;
      const long long ra = w0 > ts ? (w0 - ts + nf - 1) / nf : 0;
      const long long rb = min(cnt, (w1 - ts + nf - 1) / nf);
      if (ra >= rb) continue;
      const int nbins = lg * t_w;
      for (int f = tid; f < nf; f += blockDim.x)
        tab[f] = make_int2(off[f_lo + f] - t_lo, clip[f_lo + f]);

      for (long long c0 = ra; c0 < rb; c0 += row_cap) {
        const long long c1 = min(rb, c0 + row_cap);
        for (int k = tid; k < P * nbins; k += blockDim.x) bins[k] = 0;
        __syncthreads();
        for (long long r = c0 + tid; r < c1; r += blockDim.x) {
          const int2 rec = grow[gs + r];
          const int l = rec.y & 0xFFFF, c = rec.y >> 16;
          float v[NV];
          if constexpr (CLS) {
            v[0] = gval[gs + r];
          } else {
            const float4 q4 = reinterpret_cast<const float4*>(gval)[gs + r];
            v[0] = q4.x;
            v[1] = q4.y;
            v[2] = q4.z;
          }
          BinT q[NV];
          bool in_smem = true;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            if constexpr (B32) {
              in_smem = in_smem && fits32 && v[j] == truncf(v[j])
                        && fabsf(v[j]) <= INT32_VMAX;
              q[j] = in_smem ? (BinT)(int)v[j] : (BinT)0;
            } else {
              q[j] = (BinT)llrint((double)v[j] * sc[j]);
            }
          }
          const int pbase = (CLS ? c * nbins : 0) + l * t_w;
          const size_t gbase = ((size_t)(CLS ? c : 0) * L + l_lo + l) * T
                               + t_lo;
          auto add = [&](int f, int code) {
            const int2 tb = tab[f - f_lo];
            const int t = tb.x + min(max(code, 0), tb.y);
            if ((unsigned)t >= (unsigned)t_w) return;
            if (in_smem) {
#pragma unroll
              for (int j = 0; j < NV; ++j)
                if (q[j]) atomicAdd(&bins[j * nbins + pbase + t], q[j]);
            } else {
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                const long long qg = llrint((double)v[j] * sc[j]);
                if (qg)
                  atomicAdd(&acc[gbase + (size_t)j * L * T + t],
                            (unsigned long long)qg);
              }
            }
          };
          const CodeT* rowp = codes + (long long)rec.x * code_stride;
          if constexpr (sizeof(CodeT) == 1) {
            for (int f0 = f_lo & ~15; f0 < f_hi; f0 += 16) {
              const uint4 u = __ldg(reinterpret_cast<const uint4*>(rowp + f0));
              const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                const int f = f0 + j;
                if (f >= f_lo && f < f_hi)
                  add(f, (int)(signed char)(wd[j >> 2] >> (8 * (j & 3))));
              }
            }
          } else {
            for (int f = f_lo; f < f_hi; ++f) add(f, (int)__ldg(rowp + f));
          }
        }
        __syncthreads();
        for (int k = tid; k < P * nbins; k += blockDim.x) {
          const BinT s = bins[k];
          if (!s) continue;
          const int c = k / nbins, rem = k - c * nbins;
          const int l = rem / t_w, t = rem - l * t_w;
          unsigned long long a = (unsigned long long)s;
          if constexpr (B32) {
            int sh = S[0];
            if constexpr (!CLS) sh = c == 0 ? S[0] : (c == 1 ? S[1] : S[2]);
            a = (unsigned long long)((long long)(int)s * (1LL << sh));
          }
          atomicAdd(&acc[((size_t)c * L + l_lo + l) * T + t_lo + t], a);
        }
        __syncthreads();
      }
    }
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
                     const unsigned char* __restrict__ featok,
                     int do_scan,
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
                       && (featok[start + a] != 0) && (r < last);
    gain[row + a] = valid ? g : -CUDART_INF_F;
    rank[row + a] = r;
    lcnt[row + a] = lc;
  }
  if (f == 0)
    for (int c = tid; c < P; c += bd)
      tot0[l * P + c] = pre[(size_t)c * cap + last];
}

}  // namespace

namespace {

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

int sm_count() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  return v;
}

// most pre-pass blocks a launch may take: as many as are co-resident
int pre_cap() { return sm_count() * (2048 / PRE_THREADS); }

// Workspace of hist_accumulate: offsets (bytes) of gval, grow, gstart,
// part, pmax, gtot; returns the size.
size_t ws_layout(int n, int n_groups, int cls, size_t* o) {
  const int cap = pre_cap();
  size_t p = 0;
  o[0] = p;
  p = align16(p + (size_t)n * (cls ? 4 : 16));
  o[1] = p;
  p = align16(p + (size_t)n * 8);
  o[2] = p;
  p = align16(p + (size_t)(n_groups + 1) * 4);
  o[3] = p;
  p = align16(p + (size_t)cap * n_groups * 4);
  o[4] = p;
  p = align16(p + (size_t)cap * 3 * 4);
  o[5] = p;
  p = align16(p + (size_t)n_groups * 4);
  return p;
}

// Opts kernel `fn` in to `smem` bytes of dynamic shared memory (with
// max_shared, also to the largest shared-memory carveout) and returns the
// blocks an SM holds of it at `threads`. Done once per kernel, device and
// size: the opt-in set is the largest size cached for the kernel, so a
// cached size never finds it lowered.
template <typename Fn>
int prepare(Fn fn, int threads, size_t smem, bool max_shared) {
  struct Entry { const void* fn; int dev; size_t smem; int occ; };
  static Entry cache[64];
  static int used = 0, next = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  size_t opt = smem;
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn != (const void*)fn || cache[i].dev != dev) continue;
    if (cache[i].smem == smem) return cache[i].occ;
    opt = std::max(opt, cache[i].smem);
  }
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)opt);
  if (max_shared)
    cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem);
  cache[next] = Entry{(const void*)fn, dev, smem, occ};
  next = (next + 1) % 64;
  used = std::min(used + 1, 64);
  return occ;
}

template <typename NodeT, bool CLS, bool LOWP>
cudaError_t launch_group(const float* labels, const float* weights,
                         const void* node_v, const unsigned char* active,
                         int n, int L, int K, int l_n, int n_groups,
                         int* part, int* gtot, unsigned* pmax, int* gstart,
                         float* maxabs, int2* grow, float* gval,
                         unsigned long long* acc, long long acc_words,
                         cudaStream_t st) {
  auto fn = hist_group_kernel<NodeT, CLS, LOWP>;
  // shared memory for the most blocks a launch may take
  const size_t smem = sizeof(int) * (2 * (size_t)n_groups + pre_cap());
  const int sms = sm_count();
  const int occ = prepare(fn, PRE_THREADS, smem, false);
  if (occ < 1) return cudaErrorInvalidConfiguration;
  int grid = (int)(((long long)n + PRE_ROWS_MIN - 1) / PRE_ROWS_MIN);
  grid = std::max(1, std::min(grid, std::min(pre_cap(), occ * sms)));
  const NodeT* node = (const NodeT*)node_v;
  void* args[] = {(void*)&labels, (void*)&weights, (void*)&node,
                  (void*)&active, (void*)&n,      (void*)&L,
                  (void*)&K,      (void*)&l_n,     (void*)&n_groups,
                  (void*)&part,   (void*)&gtot,    (void*)&pmax,
                  (void*)&gstart,
                  (void*)&maxabs, (void*)&grow,    (void*)&gval,
                  (void*)&acc,    (void*)&acc_words};
  return cudaLaunchCooperativeKernel((void*)fn, dim3(grid), dim3(PRE_THREADS),
                                     args, smem, st);
}

template <typename CodeT, bool CLS, typename BinT>
void launch_acc(const void* codes, long long code_stride, const int2* grow,
                const float* gval, const int* gstart, int n_groups, int l_n,
                const int* ttile, int n_tt, int NF, int tab_bytes,
                size_t smem, const int* off, const int* clip,
                const float* maxabs, int n, int L, int T, int K,
                unsigned long long* acc, cudaStream_t st) {
  auto fn = hist_accumulate_kernel<CodeT, CLS, BinT>;
  // int32 codes keep the default carveout: a thread reads its row 4 bytes
  // at a time, and the L1 keeps the row's sector between the loads
  const int occ =
      std::max(1, prepare(fn, ACC_THREADS, smem, sizeof(CodeT) == 1));
  const double pairs = (double)n * NF;
  const int grid = std::max(
      1, (int)std::min((double)occ * sm_count(),
                       ceil(pairs / ACC_PAIRS_PER_BLOCK)));
  fn<<<grid, ACC_THREADS, smem, st>>>(
      (const CodeT*)codes, code_stride, grow, gval, gstart, n_groups, l_n,
      ttile, n_tt, NF, tab_bytes, off, clip, maxabs, n, L, T, K, acc);
}

}  // namespace

extern "C" {

// Bytes of the workspace hist_accumulate needs for n rows and n_groups
// node groups (cls: class mode).
long long hist_ws_bytes(int n, int n_groups, int cls) {
  size_t o[6];
  return (long long)ws_layout(n, n_groups, cls, o);
}

// One level's int64 accumulator acc [P, L, T] (P = K class planes for
// K >= 3, else the 3 moments) and max|comp| a plane, maxabs [K >= 3 ? 1 :
// 3], from the entry's own inputs: labels, weights (f32), node ids
// (int32, or int64 with node_is_i64), active (bool), all [n]. Two
// launches: the pre-pass (cooperative) and the accumulate. codes [n, >= F]
// with row stride code_stride: int8 (code_is_i8; stride a multiple of 16,
// 16-byte aligned) or int32. lowp: bf16 comps (moment mode). bins32: the
// 32-bit shared bins. Node groups of l_n nodes; ttile [n_tt, 5] device
// int32 slot ranges (see hist_accumulate_kernel); tab_bytes + bins a
// block = smem bytes; one accumulate block per ACC_PAIRS_PER_BLOCK (row,
// feature) pairs of n rows, at most as many as are co-resident. ws:
// ws_bytes of scratch (hist_ws_bytes).
int hist_accumulate(const void* codes, int code_is_i8, long long code_stride,
                    const float* labels, const float* weights,
                    const void* node, int node_is_i64,
                    const unsigned char* active, int n, int L, int T, int K,
                    int lowp, int bins32, int l_n, int n_groups,
                    const int* ttile, int n_tt, int NF, int tab_bytes,
                    int smem, const int* off, const int* clip, void* ws,
                    long long ws_bytes, float* maxabs, void* acc,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int cls = K >= 3;
  const int P = cls ? K : 3;
  size_t o[6];
  if ((long long)ws_layout(n, n_groups, cls, o) > ws_bytes || n_groups < 1
      || l_n < 1 || l_n > 0xFFFF || (cls && K > 0x7FFF) || n_tt < 1
      || (code_is_i8 && code_stride % 16 != 0))
    return (int)cudaErrorInvalidValue;
  char* w = (char*)ws;
  float* gval = (float*)(w + o[0]);
  int2* grow = (int2*)(w + o[1]);
  int* gstart = (int*)(w + o[2]);
  int* part = (int*)(w + o[3]);
  unsigned* pmax = (unsigned*)(w + o[4]);
  int* gtot = (int*)(w + o[5]);
  unsigned long long* a = (unsigned long long*)acc;
  const long long acc_words = (long long)P * L * T;

  cudaError_t err;
#define GROUP(NT, C, LP)                                                     \
  err = launch_group<NT, C, LP>(labels, weights, node, active, n, L, K, l_n, \
                                n_groups, part, gtot, pmax, gstart, maxabs,  \
                                grow, gval, a, acc_words, st)
#define GROUP_MODE(NT)                                                       \
  do {                                                                       \
    if (cls) GROUP(NT, true, false);                                         \
    else if (lowp) GROUP(NT, false, true);                                   \
    else GROUP(NT, false, false);                                            \
  } while (0)
  if (node_is_i64) GROUP_MODE(long long);
  else GROUP_MODE(int);
#undef GROUP_MODE
#undef GROUP
  if (err != cudaSuccess) return (int)err;

#define ACC(CT, C, BT)                                                       \
  launch_acc<CT, C, BT>(codes, code_stride, grow, gval, gstart, n_groups,    \
                        l_n, ttile, n_tt, NF, tab_bytes, (size_t)smem, off,  \
                        clip, maxabs, n, L, T, K, a, st)
#define ACC_BINS(CT, C)                                                      \
  do {                                                                       \
    if (bins32) ACC(CT, C, unsigned);                                        \
    else ACC(CT, C, unsigned long long);                                     \
  } while (0)
#define ACC_MODE(CT)                                                         \
  do {                                                                       \
    if (cls) ACC_BINS(CT, true);                                             \
    else ACC_BINS(CT, false);                                                \
  } while (0)
  if (code_is_i8) ACC_MODE(int8_t);
  else ACC_MODE(int);
#undef ACC_MODE
#undef ACC_BINS
#undef ACC
  return (int)cudaGetLastError();
}

// int64 accumulator [P, L, T] -> f32 hist [P, L, T]; with do_scan also
// gain/rank/lcnt [L, T] and tot0 [L, P]. cls_mode: P = K class planes
// (one shift, from maxabs[0]); else P = 3 moment planes. featok: [T] bool.
int hist_finalize(const void* acc, const float* maxabs, int n, int L, int T,
                  int F, int P, int cls_mode, int seg_cap, const int* off,
                  const int* slots, const int* is_cat,
                  const unsigned char* featok, int do_scan, int impurity,
                  float min_inst, float min_gain, float* hist, float* gain,
                  int* rank, float* lcnt, float* tot0, void* stream) {
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
