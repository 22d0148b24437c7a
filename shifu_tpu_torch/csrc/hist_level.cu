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
//  * The split scan, one body behind two entries: hist_finalize_kernel
//    converts the int64 accumulator to the f32 histogram as it reads it
//    (the fused entry; without the scan, the histogram-only entry's
//    conversion), hist_scan_kernel reads an f32 histogram already on the
//    card (the scan-only entry `scan_level`: the derived sibling of a
//    subtraction level and the levels past 32 nodes). It replaces the
//    in-kernel scan of hist_pallas.py (:349-450) and, for the scan-only
//    entry, the JAX package's XLA scan `_make_scan_fn`
//    (shifu_tpu/train/tree_trainer.py:631), which runs outside
//    pallas_call. Its bound is bytes: the [P, L, T] planes read once
//    (int64 or f32) and gain/rank/left count [L, T] and the node totals
//    written once, a few MB at most, under 2 us at 3.35 TB/s; so what
//    costs is latency and idle lanes. The design:
//    - work sized to the segment and the level (hist_kernel.plan_scan):
//      at a level with enough of them, a segment of at most WARP_SLOTS
//      (64) slots takes one warp, several warps a block (as many as
//      (2P + 3) words a slot fit the 227 KB a block may opt in to, at
//      most 8); at a narrow level (few jobs, so latency counts) and for
//      wider segments up to the cap, a block of 256 takes a segment;
//      wider still (the cap: SEG_CAP, or fewer slots where K planes do
//      not fit) the block only converts them and leaves their scan to
//      the wrapper's torch scan.
//    - the pairwise O(size^2) stable rank (exact ties) only for
//      categorical segments; a numeric segment's rank is its slot.
//    - ordered prefix sums as a parallel scan in f64 (a thread sums
//      CHUNK ranks, warp shuffles, then the warps' totals), rounded once
//      to f32 a slot: integer planes equal the plain version bit for
//      bit at any node total (f32 prefix sums were inexact past 2^24).
//      The node totals of a segment 0 past the cap likewise.
//    - every lane works on key, rank and gain; the kernel's dynamic
//      shared memory is set once per size (`prepare`).
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
// most slots a thread takes in a scan's ordered prefix sums
#define CHUNK 4
// widest segment a warp scans (2 slots a lane; the wrapper's plan_scan
// decides which segments take a warp), and widest one a block scans (the
// cap)
#define WARP_SLOTS 64
#define SEG_CAP (SCAN_THREADS * CHUNK)
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

// ---------------------------------------------------------------------------
// The split scan: one body, run by a warp (segments of at most WARP_SLOTS
// slots, `warps` of them a block) or by a whole block (wider segments up
// to the cap), behind two entries: hist_finalize_kernel (the int64
// accumulator, converted to the f32 histogram as it is read) and
// hist_scan_kernel (an f32 histogram already on the card).
// ---------------------------------------------------------------------------

// A segment's shared memory, (2P + 3) words a slot of m slots: h [P][m],
// pre [P][m], key [m], then ints order [m] (slot at each rank) and rnk [m]
// (rank of each slot).
struct Region {
  float* h;
  float* pre;
  float* key;
  int* order;
  int* rnk;
  int m;
  __device__ Region(float* base, int P, int m_)
      : h(base), pre(base + (size_t)P * m_), key(base + 2 * (size_t)P * m_),
        order(reinterpret_cast<int*>(base + (2 * (size_t)P + 1) * m_)),
        rnk(reinterpret_cast<int*>(base + (2 * (size_t)P + 2) * m_)),
        m(m_) {}
};

// The threads that scan one segment: a warp, or the whole block (then ws
// holds the warps' totals of a block scan).
template <bool BLOCK>
struct Group {
  int t;  // thread index in the group
  double* ws;
  __device__ int size() const { return BLOCK ? (int)blockDim.x : 32; }
  __device__ void sync() const {
    if constexpr (BLOCK) __syncthreads();
    else __syncwarp();
  }
  // Exclusive prefix of x over the group's threads in thread order, and
  // the group's total. Every thread of the group calls it.
  __device__ double scan(double x, double& total) const {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    double s = x;
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(full, s, o);
      if (lane >= o) s += y;
    }
    double ex = __shfl_up_sync(full, s, 1);
    if (lane == 0) ex = 0.0;
    if constexpr (!BLOCK) {
      total = __shfl_sync(full, s, 31);
      return ex;
    } else {
      const int wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
      if (lane == 31) ws[wid] = s;
      __syncthreads();
      double before = 0.0, tot = 0.0;
      for (int k = 0; k < nw; ++k) {
        if (k < wid) before += ws[k];
        tot += ws[k];
      }
      __syncthreads();
      total = tot;
      return before + ex;
    }
  }
};

// What a scan writes: per slot gain (-inf where invalid), rank and left
// count [L, T]; the node totals [L, P] from segment 0.
struct ScanOut {
  const unsigned char* featok;
  int impurity;
  float min_inst, min_gain;
  float* gain;
  int* rank;
  float* lcnt;
  float* tot0;
  int L, T, P, cls;
};

// The work division (the wrapper's plan_scan): jobs are (node, feature).
// Blocks [0, warp_blocks) give each warp one job of wfeat (n_w features,
// node-major, `warps` a block, wseg slots of shared memory a warp); the
// rest give the block one job of bfeat (n_b features: wider than a warp's
// share, or past the cap, bseg slots of shared memory).
struct ScanJobs {
  const int* off;
  const int* slots;
  const int* is_cat;
  const int* wfeat;
  const int* bfeat;
  int n_w, n_b, warps, wseg, bseg, cap, warp_blocks;
};

// The int64 fixed-point accumulator, converted to f32 as the fused entry
// reads it; load() also writes the f32 histogram. inv: the planes' 2^-S,
// set by set_inv in shared memory.
struct AccSrc {
  const unsigned long long* acc;
  const float* maxabs;
  float* hist;
  int n, L, T, cls;
  const double* inv;
  // 2^-S of each plane's fixed-point shift, once a block (class planes
  // share one, from max|w|); a barrier follows
  __device__ void set_inv(double* s_inv) {
    if (threadIdx.x < 3)
      s_inv[threadIdx.x] =
          ldexp(1.0, -plane_shift(maxabs[cls ? 0 : threadIdx.x], n));
    __syncthreads();
    inv = s_inv;
  }
  __device__ float value(int c, int l, int t) const {
    return (float)((double)(long long)acc[((size_t)c * L + l) * T + t]
                   * inv[cls ? 0 : c]);
  }
  __device__ float load(int c, int l, int t) const {
    const float v = value(c, l, t);
    hist[((size_t)c * L + l) * T + t] = v;
    return v;
  }
};

// An f32 histogram already on the card (the scan-only entry).
struct F32Src {
  const float* hist;
  int L, T;
  __device__ float value(int c, int l, int t) const {
    return hist[((size_t)c * L + l) * T + t];
  }
  __device__ float load(int c, int l, int t) const { return value(c, l, t); }
};

// Scans segment (l, f) in region R: stable rank on (key, slot), ordered
// prefix sums in f64 rounded once a slot, gain and validity a slot, and
// the node totals where f is segment 0.
template <bool BLOCK, typename Src>
__device__ void scan_segment(const Src& src, const Group<BLOCK>& g,
                             const Region& R, int l, int f,
                             const ScanJobs& J, const ScanOut& o) {
  const int G = g.size(), P = o.P, m = R.m;
  const int start = J.off[f], size = J.slots[f];
  for (int s = g.t; s < size; s += G)
    for (int c = 0; c < P; ++c) R.h[(size_t)c * m + s] = src.load(c, l, start + s);
  g.sync();

  if (J.is_cat[f]) {
    // categorical segments sort by mean label (class mode: by expected
    // class index sum_c c*h_c / sum_c h_c), empty slots last (+inf)
    for (int s = g.t; s < size; s += G) {
      float cnt, num;
      if (o.cls) {
        cnt = R.h[s];
        for (int c = 1; c < P; ++c) cnt = cnt + R.h[(size_t)c * m + s];
        num = 0.f;
        for (int c = 0; c < P; ++c) num = num + (float)c * R.h[(size_t)c * m + s];
      } else {
        cnt = R.h[s];
        num = R.h[m + s];
      }
      R.key[s] = cnt > 0.f ? num / fmaxf(cnt, 1e-12f) : CUDART_INF_F;
    }
    g.sync();
    // stable lex rank on (key, slot): a stable sort's position
    for (int a = g.t; a < size; a += G) {
      const float ka = R.key[a];
      int r = 0;
      for (int b = 0; b < size; ++b) {
        const float kb = R.key[b];
        r += (kb < ka) || (kb == ka && b < a);
      }
      R.rnk[a] = r;
      R.order[r] = a;
    }
  } else {  // numeric segments keep slot order: the rank is the slot
    for (int s = g.t; s < size; s += G) {
      R.rnk[s] = s;
      R.order[s] = s;
    }
  }
  g.sync();

  // inclusive prefix sums in rank order, in f64, rounded once a slot:
  // thread t sums ranks [t*k, t*k + k) (k <= CHUNK), the group scans the
  // threads' totals
  const int k = (size + G - 1) / G;
  const int r0 = g.t * k;
  for (int c = 0; c < P; ++c) {
    const float* hc = R.h + (size_t)c * m;
    double run[CHUNK];
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int r = r0 + j;
      if (j < k && r < size) acc += (double)hc[R.order[r]];
      run[j] = acc;
    }
    double total;
    const double ex = g.scan(acc, total);
    float* pc = R.pre + (size_t)c * m;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int r = r0 + j;
      if (j < k && r < size) pc[r] = (float)(ex + run[j]);
    }
  }
  g.sync();

  const int last = size - 1;
  const bool entropy = o.impurity == 2;
  const size_t row = (size_t)l * o.T + start;
  for (int a = g.t; a < size; a += G) {
    const int r = R.rnk[a];
    float lc, rc, gn;
    if (o.cls) {
      lc = R.pre[r];
      rc = R.pre[last] - R.pre[r];
      for (int c = 1; c < P; ++c) {
        const float* pc = R.pre + (size_t)c * m;
        lc = lc + pc[r];
        rc = rc + (pc[last] - pc[r]);
      }
      const float tc = lc + rc;
      // tc*h_tot - lc*h_left - rc*h_right, contracted as the XLA scan
      const float hl = class_impurity(R.pre, m, P, r, last, 0, lc, entropy);
      const float hr = class_impurity(R.pre, m, P, r, last, 1, rc, entropy);
      const float ht = class_impurity(R.pre, m, P, r, last, 2, tc, entropy);
      gn = fmaf(-rc, hr, fmaf(tc, ht, -(lc * hl)));
    } else {
      const float* p1 = R.pre + m;
      const float* p2 = R.pre + 2 * (size_t)m;
      const float tc = R.pre[last], ts1 = p1[last], ts2 = p2[last];
      lc = R.pre[r];
      const float ls1 = p1[r], ls2 = p2[r];
      rc = tc - lc;
      gn = split_gain(o.impurity, lc, ls1, ls2, rc, ts1 - ls1, ts2 - ls2, tc,
                      ts1, ts2);
    }
    const bool valid = (lc >= o.min_inst) && (rc >= o.min_inst)
                       && (gn > o.min_gain) && (o.featok[start + a] != 0)
                       && (r < last);
    o.gain[row + a] = valid ? gn : -CUDART_INF_F;
    o.rank[row + a] = r;
    o.lcnt[row + a] = lc;
  }
  if (f == 0)
    for (int c = g.t; c < P; c += G)
      o.tot0[l * P + c] = R.pre[(size_t)c * m + last];
}

// A segment past the cap: the wrapper's torch scan owns its columns; the
// block converts them (fused entry), marks them invalid, and where it is
// segment 0 sums the node totals in f64 (rounded once).
template <typename Src>
__device__ void wide_segment(const Src& src, const Group<true>& g, int l,
                             int f, const ScanJobs& J, const ScanOut& o) {
  const int G = g.size();
  const int start = J.off[f], size = J.slots[f];
  const size_t row = (size_t)l * o.T + start;
  for (int s = g.t; s < size; s += G) {
    for (int c = 0; c < o.P; ++c) src.load(c, l, start + s);
    o.gain[row + s] = -CUDART_INF_F;
    o.rank[row + s] = s;
    o.lcnt[row + s] = 0.f;
  }
  if (f != 0) return;
  for (int c = 0; c < o.P; ++c) {
    double part = 0.0, total;
    for (int s = g.t; s < size; s += G) part += (double)src.value(c, l, start + s);
    g.scan(part, total);
    if (g.t == 0) o.tot0[l * o.P + c] = (float)total;
  }
}

// Block b runs its jobs (see ScanJobs). Warp jobs touch no block barrier,
// so idle warps leave at once.
template <typename Src>
__device__ void scan_jobs(const Src& src, const ScanJobs& J,
                          const ScanOut& o, float* smem, double* ws) {
  const int words = 2 * o.P + 3;
  if ((int)blockIdx.x < J.warp_blocks) {
    const int w = threadIdx.x >> 5;
    const long long j = (long long)blockIdx.x * J.warps + w;
    if (w >= J.warps || j >= (long long)o.L * J.n_w) return;
    const Group<false> g{(int)(threadIdx.x & 31), nullptr};
    const Region R(smem + (size_t)w * words * J.wseg, o.P, J.wseg);
    scan_segment(src, g, R, (int)(j / J.n_w), J.wfeat[j % J.n_w], J, o);
  } else {
    const long long j = blockIdx.x - J.warp_blocks;
    const int l = (int)(j / J.n_b), f = J.bfeat[j % J.n_b];
    const Group<true> g{(int)threadIdx.x, ws};
    if (J.slots[f] > J.cap) wide_segment(src, g, l, f, J, o);
    else scan_segment(src, g, Region(smem, o.P, J.bseg), l, f, J, o);
  }
}

// The fused and histogram-only entries' last launch: the int64
// accumulator -> the f32 histogram, and with SCAN the split scan of every
// (node, segment). Without SCAN a grid-stride conversion.
template <bool SCAN>
__global__ void __launch_bounds__(SCAN_THREADS)
hist_finalize_kernel(AccSrc src, ScanJobs J, ScanOut o) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double ws[SCAN_THREADS / 32];
  __shared__ double s_inv[3];
  src.set_inv(s_inv);
  if constexpr (SCAN) {
    scan_jobs(src, J, o, smem, ws);
  } else {
    const long long total = (long long)o.P * o.L * o.T;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += (long long)gridDim.x * blockDim.x) {
      const int t = (int)(k % o.T);
      const long long cl = k / o.T;
      src.load((int)(cl / o.L), (int)(cl % o.L), t);
    }
  }
}

// The scan-only entry: the split scan of an f32 [P, L, T] histogram.
__global__ void __launch_bounds__(SCAN_THREADS)
hist_scan_kernel(F32Src src, ScanJobs J, ScanOut o) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double ws[SCAN_THREADS / 32];
  scan_jobs(src, J, o, smem, ws);
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


// Checks a scan plan against the kernels' limits, then launches `fn` on
// its jobs (shared memory set once per kernel and size, by prepare).
template <typename Src>
cudaError_t launch_scan(void (*fn)(Src, ScanJobs, ScanOut), const Src& src,
                        ScanJobs J, const ScanOut& o, int smem,
                        cudaStream_t st) {
  const size_t words = (2 * (size_t)o.P + 3) * sizeof(float);
  if (J.cap < 0 || J.cap > SEG_CAP || J.wseg < 0 || J.wseg > WARP_SLOTS
      || J.wseg > J.cap || J.bseg < 0 || J.bseg > J.cap || J.warps < 1
      || J.warps > SCAN_THREADS / 32 || J.n_w < 0 || J.n_b < 0
      || (J.n_w > 0 && J.wseg < 1) || smem < 0
      || (size_t)smem < std::max(J.warps * words * J.wseg, words * J.bseg))
    return cudaErrorInvalidValue;
  J.warp_blocks = (int)(((long long)o.L * J.n_w + J.warps - 1) / J.warps);
  const long long grid = J.warp_blocks + (long long)o.L * J.n_b;
  if (grid == 0) return cudaSuccess;
  if (prepare(fn, SCAN_THREADS, (size_t)smem, false) < 1)
    return cudaErrorInvalidConfiguration;
  fn<<<(unsigned)grid, SCAN_THREADS, smem, st>>>(src, J, o);
  return cudaGetLastError();
}

ScanJobs scan_jobs_of(const int* off, const int* slots, const int* is_cat,
                      const int* wfeat, int n_w, const int* bfeat, int n_b,
                      int wseg, int warps, int bseg, int cap) {
  return ScanJobs{off, slots, is_cat, wfeat, bfeat, n_w, n_b, warps, wseg,
                  bseg, cap, 0};
}

ScanOut scan_out_of(const unsigned char* featok, int impurity,
                    float min_inst, float min_gain, float* gain, int* rank,
                    float* lcnt, float* tot0, int L, int T, int P,
                    int cls_mode) {
  return ScanOut{featok, impurity, min_inst, min_gain, gain, rank, lcnt,
                 tot0, L, T, P, cls_mode};
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

// int64 accumulator [P, L, T] -> f32 hist [P, L, T] (the histogram-only
// entry's last launch). cls_mode: P = K class planes, one shift (from
// maxabs[0]); else P = 3 moment planes.
int hist_convert(const void* acc, const float* maxabs, int n, int L, int T,
                 int P, int cls_mode, float* hist, void* stream) {
  const long long total = (long long)P * L * T;
  if (total == 0) return 0;
  const AccSrc src{(const unsigned long long*)acc, maxabs, hist, n, L, T,
                   cls_mode, nullptr};
  const ScanOut o = scan_out_of(nullptr, 0, 0.f, 0.f, nullptr, nullptr,
                                nullptr, nullptr, L, T, P, cls_mode);
  const int grid = (int)std::min<long long>(
      (total + SCAN_THREADS - 1) / SCAN_THREADS, (long long)sm_count() * 8);
  hist_finalize_kernel<false><<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      src, ScanJobs{}, o);
  return (int)cudaGetLastError();
}

// The fused entry's last launch: the int64 accumulator -> f32 hist, and
// the split scan of every (node, segment): gain/rank/lcnt [L, T] and tot0
// [L, P]. The plan (hist_kernel.plan_scan): features wfeat [n_w] take a
// warp each (wseg slots of shared memory, `warps` a block), bfeat [n_b] a
// block each (bseg slots; past `cap` slots the segment is left to the
// wrapper's torch scan); smem bytes of dynamic shared memory a block.
// off/slots/is_cat: [F] int32; featok: [T] bool; impurity: 0 variance, 1
// friedmanmse, 2 entropy, 3 gini.
int hist_finalize(const void* acc, const float* maxabs, int n, int L, int T,
                  int P, int cls_mode, float* hist, const int* off,
                  const int* slots, const int* is_cat, const int* wfeat,
                  int n_w, const int* bfeat, int n_b, int wseg, int warps,
                  int bseg, int cap, int smem, const unsigned char* featok,
                  int impurity, float min_inst, float min_gain, float* gain,
                  int* rank, float* lcnt, float* tot0, void* stream) {
  const AccSrc src{(const unsigned long long*)acc, maxabs, hist, n, L, T,
                   cls_mode, nullptr};
  return (int)launch_scan(
      hist_finalize_kernel<true>, src,
      scan_jobs_of(off, slots, is_cat, wfeat, n_w, bfeat, n_b, wseg, warps,
                   bseg, cap),
      scan_out_of(featok, impurity, min_inst, min_gain, gain, rank, lcnt,
                  tot0, L, T, P, cls_mode),
      smem, (cudaStream_t)stream);
}

// The scan-only entry: the split scan of an f32 histogram hist [P, L, T]
// already on the card; the rest as hist_finalize.
int hist_scan(const float* hist, int L, int T, int P, int cls_mode,
              const int* off, const int* slots, const int* is_cat,
              const int* wfeat, int n_w, const int* bfeat, int n_b, int wseg,
              int warps, int bseg, int cap, int smem,
              const unsigned char* featok, int impurity, float min_inst,
              float min_gain, float* gain, int* rank, float* lcnt,
              float* tot0, void* stream) {
  return (int)launch_scan(
      hist_scan_kernel, F32Src{hist, L, T},
      scan_jobs_of(off, slots, is_cat, wfeat, n_w, bfeat, n_b, wseg, warps,
                   bseg, cap),
      scan_out_of(featok, impurity, min_inst, min_gain, gain, rank, lcnt,
                  tot0, L, T, P, cls_mode),
      smem, (cudaStream_t)stream);
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
