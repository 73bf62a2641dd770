// The slice kernel shared by K2 SPA (spa.cu) and K3 SPARS (spars.cu).
//
// Both compute, for one group of C columns, a dense accumulator tile
// [m, n_b] in which cell (r, j) takes the products A[r, k] * B[k, j] of
// lane j in (B entry e, A entry z) order, starting from 0.0f.  The unit of
// work is kCols adjacent C columns x one slice of kThreads rows, so a long
// column is split over m / kThreads slices, and every cell of the slice has
// one owner, so there are no atomics.  Two CTAs share a (column group,
// slice): one takes the group's columns with at most kPhaseEntries B entries
// (phase mode), the other the rest (list mode), so a long column does not
// wait for its neighbours.  Both walk their B entries in chunks: A column, B
// value and A column length loaded by all threads at once, a block scan
// turning the lengths into product offsets in (e, z) order; then rounds in
// which thread t loads the row and value of kPerThread consecutive products
// (independent loads, all in flight together) and keeps those whose row
// lies in the slice.  The dependent global loads of a one-lane-at-a-time
// walk thus become one chain a chunk and one a round, each shared by
// thousands of products.
// - Phase mode: the cells live in shared memory.  In phase s every column of
//   the pass adds the products of its entry s; the rows of one A column are
//   distinct, so no two products of a phase name one cell, and a barrier
//   orders the phases.
// - List mode (one column at a time): thread t owns row r0 + t and adds in
//   a register.  A round's kept products are ranked per owner warp (16-bit
//   counts, four to a 64-bit word, in one block scan) and written into one
//   bucket a warp, in (e, z) order; each warp walks its bucket, every lane
//   adding every product, +0.0f where the row is not its own (acc starts at
//   +0.0f and a sum that rounds to nearest never makes it -0.0f, so adding
//   +0.0f leaves it bit for bit as it was).  The lists are double-buffered,
//   so a warp walking a long bucket (iprob's arrow row takes 3000 products
//   from one column) holds up only the next round's barrier.
// __fmul_rn/__fadd_rn keep nvcc from contracting a product and its sum into
// an FMA.  A's padded columns need not be sorted by row.  The slice's cells
// are stored once, as runs of adjacent floats, every cell included, so the
// wrappers allocate their outputs with torch.empty.
//
// kLockStep = true is SPARS, the paper's lock-step lanes (Algorithm 3), as
// the reference's kernel runs them.  Three differences from SPA:
// 1. A B entry whose A column is empty still takes one step: it multiplies
//    the padding slot a_vals[k, 0] by the B value and adds the product to row
//    a_rows[k, 0], whatever that slot holds.  An entry's product count is
//    max(na, 1), so the block scan counts steps.
// 2. Column c stops after steps[c / block_cols] steps, which may cut an A
//    column.  Each column's first entry records in shared memory the product
//    index of the pass where its steps end (lim); a round keeps a product
//    only below its column's lim, and a list-mode pass stops at its cap.
// 3. A second tile, flags, marks each cell that took a product: a byte a
//    cell in shared memory in phase mode (a bit would make two columns'
//    products of one phase in one row race on the byte), a register of the
//    owner in list mode, set only by the owner's own rows (never by the
//    +0.0f adds of other rows).
// The product order of each cell is SPA's, so at full trip counts K3's acc
// equals K2's output bit for bit.
//
// Batch: blockIdx.y is the batch element, as vmap makes the batch a leading
// grid axis on the TPU.  Element b reads a_vals + b*n_a*za and
// b_vals + b*n_b*zb and writes out (and flags) + b*m*n_b (int64 offsets: at
// iprob the padded A operand alone holds 9.0M slots per element); the index
// operands and trip counts are shared.  Each element runs exactly the
// unbatched arithmetic, so batched equals looped bit for bit, and the
// unbatched launch is batch = 1.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;                 // CTA threads = slice rows
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                      // adjacent C columns a CTA
constexpr int kPhaseEntries = 64;             // more B entries: list mode
constexpr int kEntriesPerThread = 4;
constexpr int kEntries = kThreads * kEntriesPerThread;   // B entries a chunk
constexpr int kPerThread = 8;                 // products a thread a round
constexpr int kRound = kThreads * kPerThread;  // products a round
// list mode cuts the list into one bucket a warp; bucket sizes are counted
// in 16-bit fields, four to a 64-bit word
constexpr int kWords = (kWarps + 3) / 4;
static_assert(kRound < (1 << 16), "a bucket's count must fit 16 bits");
static_assert((kEntries & (kEntries - 1)) == 0, "binary search over kEntries");
static_assert(kCols <= 32, "the columns of a pass are one bit mask");

// Shared memory, from the dynamic allocation (past 48 KB).
struct Smem {
  int64_t ent_at[kEntries];      // A slot of product 0 of each entry
  int2 list[2][kRound];          // (row - r0, product bits), bucketed
  unsigned long long warp_counts[2][kWords][kWarps];
  float cells[kThreads][kCols + 1];   // the slice x columns; +1: no bank
                                      // conflicts down a column
  int off[kEntries + 1];         // product offset of each entry
  float ent_bv[kEntries];
  int ent_js[kEntries];          // column slot << 16 | entry index in it
  int warp_sum[kWarps];
  int warp_lo[kWarps], warp_hi[kWarps];
};

// SPARS's shared memory: SPA's, then the flags and the trip counts' ends.
struct LockStepSmem : Smem {
  unsigned char flag[kThreads][kCols];   // phase mode: cells that took a
                                         // product
  int lim[kCols];   // product index of the pass where each column's steps end
};

// Inclusive sum of v over the CTA's threads up to this one; *total gets the
// CTA's sum.  One __syncthreads; warp_sum must not be rewritten before every
// thread has passed the next barrier.
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sum[w];
    if (w < warp) v += s;
    sum += s;
  }
  *total = sum;
  return v;
}

// The entry of product p: the last entry whose offset is <= p.
__device__ __forceinline__ int entry_of(const int* off, int p) {
  int x = 0;
#pragma unroll
  for (int step = kEntries / 2; step > 0; step >>= 1)
    if (off[x + step] <= p) x += step;
  return x;
}

// Element i of a small register array.  The array is masked, never indexed
// by i: a select between array elements would become a local array.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) v |= a[j] & (T(0) - T(i == j));
  return v;
}

// The 16-bit field of bucket b in the words c; bump adds one to it.
__device__ __forceinline__ int field(const unsigned long long (&c)[kWords],
                                     int b) {
  return static_cast<int>((pick(c, b >> 2) >> (16 * (b & 3))) & 0xffffu);
}

__device__ __forceinline__ void bump(unsigned long long (&c)[kWords], int b) {
  const unsigned long long one = 1ull << (16 * (b & 3));
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    c[w] += one & (0ull - static_cast<unsigned long long>((b >> 2) == w));
}

// SPA (kLockStep false: steps, block_cols and flags unused) or SPARS.
template <bool kLockStep>
__global__ void __launch_bounds__(kThreads, 1)
slice_kernel(const int* __restrict__ a_rows, const float* __restrict__ a_vals,
             const int* __restrict__ a_nnz, int n_a, int za,
             const int* __restrict__ b_rows, const float* __restrict__ b_vals,
             const int* __restrict__ b_nnz, int n_b, int zb,
             const int* __restrict__ steps, int block_cols, int m,
             int n_slices, float* __restrict__ out,
             float* __restrict__ flags) {
  using S = std::conditional_t<kLockStep, LockStepSmem, Smem>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int64_t elem = blockIdx.y;
  a_vals += elem * n_a * za;
  b_vals += elem * n_b * zb;
  out += elem * m * n_b;
  if constexpr (kLockStep) flags += elem * m * n_b;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  // blockIdx.x: (column group, slice, task): task 0 takes the group's
  // phase-mode columns, task 1 its list-mode columns, so that one long
  // column does not wait for its neighbours
  const bool list_task = blockIdx.x & 1;
  const int r0 = (blockIdx.x / 2 % n_slices) * kThreads;
  const int c0 = (blockIdx.x / 2 / n_slices) * kCols;
  const int rows_here = min(kThreads, m - r0);
  const int n_cols = min(kCols, n_b - c0);
  // SPARS: an empty A column still takes a step, on its slot 0
  const int min_count = kLockStep && za > 0;

  // phase mode takes the columns with few B entries, in one pass; list
  // mode gives each other column a pass of its own
  int nbj[kCols];
  int cap[kCols];   // SPARS: each column's trip count
  unsigned phase_cols = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    nbj[j] = j < n_cols ? b_nnz[c0 + j] : 0;
    cap[j] = 0;
    if constexpr (kLockStep)
      if (j < n_cols) cap[j] = steps[(c0 + j) / block_cols];
    if (j < n_cols && nbj[j] <= kPhaseEntries) phase_cols |= 1u << j;
  }
  const unsigned task_cols = list_task ? ~phase_cols & ((1u << n_cols) - 1)
                                       : phase_cols;
  if (task_cols == 0) return;   // uniform: the task has no column
  for (int i = t; i < kThreads * (kCols + 1); i += kThreads)
    (&sm.cells[0][0])[i] = 0.0f;
  if constexpr (kLockStep)
    for (int i = t; i < kThreads * kCols; i += kThreads)
      (&sm.flag[0][0])[i] = 0;
  int buf = 0;   // list mode: the round's list and counts

  for (int pass = list_task ? 0 : -1; pass < (list_task ? n_cols : 0);
       ++pass) {
    const bool phases = pass < 0;
    const unsigned cols = phases ? phase_cols
                                 : (phase_cols >> pass & 1u ? 0u : 1u << pass);
    if (cols == 0) continue;
    int pre[kCols + 1];   // first entry of each column in the pass
    pre[0] = 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      pre[j + 1] = pre[j] + (cols >> j & 1u ? nbj[j] : 0);
    const int n_ent = pre[kCols];
    float acc = 0.0f;   // list mode: the cell of row r0 + t
    bool hit = false;   // SPARS, list mode: that cell took a product
    int base = 0;       // SPARS: products of the pass's earlier chunks

    for (int e0 = 0; e0 < n_ent; e0 += kEntries) {
      if constexpr (kLockStep)
        if (!phases && base >= pick(cap, pass)) break;   // uniform
      // the chunk's entries: A column, B value, product offset, column slot
      int na[kEntriesPerThread];
      int64_t at[kEntriesPerThread];
      int first[kEntriesPerThread];   // SPARS: the column this entry opens
      int mine = 0;
#pragma unroll
      for (int i = 0; i < kEntriesPerThread; ++i) {
        const int x = t * kEntriesPerThread + i;
        const int e = e0 + x;
        int k = 0, js = 0;
        float bv = 0.0f;
        na[i] = 0;
        first[i] = -1;
        if (e < n_ent) {
          // the last column whose first entry is <= e: it holds entry e
          int j = 0;
#pragma unroll
          for (int jj = 1; jj < kCols; ++jj) j += e >= pre[jj];
          const int local = e - pick(pre, j);
          const int64_t b = static_cast<int64_t>(c0 + j) * zb + local;
          k = b_rows[b];
          bv = b_vals[b];
          na[i] = a_nnz[k];
          js = j << 16 | local;
          if constexpr (kLockStep) {
            na[i] = max(na[i], min_count);
            if (local == 0) first[i] = j;
          }
        }
        at[i] = static_cast<int64_t>(k) * za;
        sm.ent_bv[x] = bv;
        sm.ent_js[x] = js;
        mine += na[i];
      }
      int n_prod;
      int o = block_scan(mine, sm.warp_sum, &n_prod) - mine;
#pragma unroll
      for (int i = 0; i < kEntriesPerThread; ++i) {
        sm.off[t * kEntriesPerThread + i] = o;
        sm.ent_at[t * kEntriesPerThread + i] = at[i] - o;
        if constexpr (kLockStep) {
          if (first[i] >= 0) {
            const long long end = static_cast<long long>(base) + o +
                                  pick(cap, first[i]);
            sm.lim[first[i]] = static_cast<int>(min(end, (long long)INT_MAX));
          }
        }
        o += na[i];
      }
      if (t == 0) sm.off[kEntries] = n_prod;
      __syncthreads();
      for (int p0 = 0; p0 < n_prod; p0 += kRound, buf ^= 1) {
        // this thread's products [lo, hi) of the round, in (e, z) order:
        // addresses first, then every load at once, no branch waiting on one
        const int lo = min(p0 + t * kPerThread, n_prod);
        const int hi = min(lo + kPerThread, n_prod);
        int x = entry_of(sm.off, lo);
        int64_t addr[kPerThread];
        int js[kPerThread];
        float bv[kPerThread];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int p = lo + q;
          addr[q] = -1;
          js[q] = 0;
          bv[q] = 0.0f;
          if (p < hi) {
            while (sm.off[x + 1] <= p) ++x;   // past empty A columns
            addr[q] = sm.ent_at[x] + p;
            js[q] = sm.ent_js[x];
            bv[q] = sm.ent_bv[x];
          }
        }
        int row[kPerThread];
        float prod[kPerThread];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          row[q] = -1;
          prod[q] = 0.0f;
          if (addr[q] >= 0) {
            row[q] = __ldg(a_rows + addr[q]) - r0;
            prod[q] = __ldg(a_vals + addr[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          bool keep = addr[q] >= 0 && static_cast<unsigned>(row[q]) <
                                          static_cast<unsigned>(rows_here);
          // SPARS: only the column's first cap steps
          if constexpr (kLockStep)
            keep = keep && base + lo + q < sm.lim[js[q] >> 16];
          if (keep)
            prod[q] = __fmul_rn(prod[q], bv[q]);
          else
            row[q] = -1;
        }
        if (phases) {
          // the phases of this round: the range of its entries' indices
          int s_lo = 1 << 30, s_hi = -1;
#pragma unroll
          for (int q = 0; q < kPerThread; ++q) {
            if (addr[q] >= 0) {
              s_lo = min(s_lo, js[q] & 0xffff);
              s_hi = max(s_hi, js[q] & 0xffff);
            }
          }
          s_lo = __reduce_min_sync(0xffffffffu, s_lo);
          s_hi = __reduce_max_sync(0xffffffffu, s_hi);
          if (lane == 0) {
            sm.warp_lo[warp] = s_lo;
            sm.warp_hi[warp] = s_hi;
          }
          __syncthreads();
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            s_lo = min(s_lo, sm.warp_lo[w]);
            s_hi = max(s_hi, sm.warp_hi[w]);
          }
          for (int ph = s_lo; ph <= s_hi; ++ph) {
            // this thread's products of phase ph name distinct cells: read
            // them all, then write them all
            float cell[kPerThread];
#pragma unroll
            for (int q = 0; q < kPerThread; ++q)
              cell[q] = row[q] >= 0 && (js[q] & 0xffff) == ph
                            ? sm.cells[row[q]][js[q] >> 16] : 0.0f;
#pragma unroll
            for (int q = 0; q < kPerThread; ++q) {
              if (row[q] >= 0 && (js[q] & 0xffff) == ph) {
                sm.cells[row[q]][js[q] >> 16] = __fadd_rn(cell[q], prod[q]);
                if constexpr (kLockStep) sm.flag[row[q]][js[q] >> 16] = 1;
              }
            }
            __syncthreads();
          }
          continue;
        }
        // list mode: one bucket a warp (the products whose row it owns),
        // ranked by kWords word scans under one barrier
        unsigned long long mine_b[kWords], rank[kWords], start[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) mine_b[w] = 0;
#pragma unroll
        for (int q = 0; q < kPerThread; ++q)
          if (row[q] >= 0) bump(mine_b, row[q] >> 5);
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          unsigned long long v = mine_b[w];
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const unsigned long long n = __shfl_up_sync(0xffffffffu, v, d);
            if (lane >= d) v += n;
          }
          rank[w] = v;
          if (lane == 31) sm.warp_counts[buf][w][warp] = v;
        }
        __syncthreads();
        unsigned long long before = 0;   // hits in the buckets of words < w
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          unsigned long long total = 0;
#pragma unroll
          for (int i = 0; i < kWarps; ++i) {
            const unsigned long long c = sm.warp_counts[buf][w][i];
            if (i < warp) rank[w] += c;
            total += c;
          }
          // field f of total * 0x0001000100010000 is the sum of the fields
          // below f (none passes 16 bits): where each bucket starts
          start[w] = total * 0x0001000100010000ull +
                     before * 0x0001000100010001ull;
          before += (total & 0xffffu) + ((total >> 16) & 0xffffu) +
                    ((total >> 32) & 0xffffu) + (total >> 48);
          rank[w] += start[w] - mine_b[w];   // this thread's hits' slots
        }
        int2* list = sm.list[buf];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          if (row[q] >= 0) {
            const int b = row[q] >> 5;
            list[field(rank, b)] = make_int2(row[q], __float_as_int(prod[q]));
            bump(rank, b);
          }
        }
        __syncthreads();
        // each warp walks its own bucket, in (e, z) order, adding +0.0f
        // for rows not its lanes' own; no barrier after it: the next round
        // fills the other buffer
        int h = field(start, warp);
        const int h1 = warp + 1 < kWarps ? field(start, warp + 1)
                                         : static_cast<int>(before);
        if (h < h1 && (h & 1)) {   // to an even slot: two entries a load
          const int2 v = list[h++];
          acc = __fadd_rn(acc, v.x == t ? __int_as_float(v.y) : 0.0f);
          if constexpr (kLockStep) hit |= v.x == t;
        }
        // eight entries a step, the next step's loads already in flight
        const int4* v4 = reinterpret_cast<const int4*>(list + h);
        const int n_steps = (h1 - h) >> 3;
        int4 c0{}, c1{}, c2{}, c3{};
        if (n_steps > 0) {
          c0 = v4[0];
          c1 = v4[1];
          c2 = v4[2];
          c3 = v4[3];
        }
        for (int i = 0; i < n_steps; ++i) {
          int4 n0 = c0, n1 = c1, n2 = c2, n3 = c3;
          if (i + 1 < n_steps) {
            n0 = v4[4 * i + 4];
            n1 = v4[4 * i + 5];
            n2 = v4[4 * i + 6];
            n3 = v4[4 * i + 7];
          }
          acc = __fadd_rn(acc, c0.x == t ? __int_as_float(c0.y) : 0.0f);
          acc = __fadd_rn(acc, c0.z == t ? __int_as_float(c0.w) : 0.0f);
          acc = __fadd_rn(acc, c1.x == t ? __int_as_float(c1.y) : 0.0f);
          acc = __fadd_rn(acc, c1.z == t ? __int_as_float(c1.w) : 0.0f);
          acc = __fadd_rn(acc, c2.x == t ? __int_as_float(c2.y) : 0.0f);
          acc = __fadd_rn(acc, c2.z == t ? __int_as_float(c2.w) : 0.0f);
          acc = __fadd_rn(acc, c3.x == t ? __int_as_float(c3.y) : 0.0f);
          acc = __fadd_rn(acc, c3.z == t ? __int_as_float(c3.w) : 0.0f);
          if constexpr (kLockStep)
            hit |= c0.x == t || c0.z == t || c1.x == t || c1.z == t ||
                   c2.x == t || c2.z == t || c3.x == t || c3.z == t;
          c0 = n0;
          c1 = n1;
          c2 = n2;
          c3 = n3;
        }
        for (h += n_steps << 3; h < h1; ++h) {
          const int2 v = list[h];
          acc = __fadd_rn(acc, v.x == t ? __int_as_float(v.y) : 0.0f);
          if constexpr (kLockStep) hit |= v.x == t;
        }
      }
      base += n_prod;
    }
    if (!phases) {
      sm.cells[t][pass] = acc;
      if constexpr (kLockStep) sm.flag[t][pass] = hit;
    }
  }
  __syncthreads();
  for (int i = t; i < rows_here * n_cols; i += kThreads) {
    const int r = i / n_cols;
    const int j = i - r * n_cols;
    if (task_cols >> j & 1u) {
      const int64_t cell = static_cast<int64_t>(r0 + r) * n_b + c0 + j;
      out[cell] = sm.cells[r][j];
      if constexpr (kLockStep) flags[cell] = sm.flag[r][j] ? 1.0f : 0.0f;
    }
  }
}

}  // namespace
