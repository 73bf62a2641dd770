// K5 padded-BSR x dense (SpMM) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bsr_spmm.py, _bsr_kernel (the Pallas TPU kernel
// behind bsr_spmm) and its vmapped form in src/repro/models/sparse_ffn.py
// (SparseMatmul.batched, K5-b).  Same operands: padded BSR weight
// block_idx [n_rb, max_nb] int32, block_nnz [n_rb] int32,
// blocks [n_rb, max_nb, bm, bk], and dense activations x [K, N]; same
// output out [n_rb * bm, N].  The batched form takes B activation sets
// x [B, K, N] against one weight and writes out [B, n_rb * bm, N].
//
// Types: the reference's contract.  blocks and x are each f32 or bf16, the
// sums are f32 and the output is in x's type, rounded once where it is
// stored.  Two bodies serve the instances (choose_layout picks one, and
// repro_bsr_layout reports the choice without a launch):
//
// - the tensor-core body (bsr_mma_kernel) for 8 x 8 blocks on bf16 x whose
//   rows are a multiple of 16 bytes (N % 8 == 0), x, the blocks and out
//   16-byte aligned: the sparse FFN's bf16 path, f32 or bf16 blocks;
// - the SIMT body (bsr_kernel) for everything else: f32 x on any blocks
//   (the 8 x 8 instances, 256 or 128 columns a tile, x staged by TMA, and
//   the generic one), bf16 x on any other block shape or on unaligned or
//   ragged rows (the generic instance), and bf16 blocks on f32 x (which no
//   path of either package calls).
//
// What bounds it: operations.  Every kept block does 2 * bm * bk * N flops
// against bm * bk weights and bk * N activations read; at the sparse FFN's
// widths (K = 6144, N = 2048) that is hundreds of flops per byte of the
// operands, above the card's ridge in f32 (67 TFLOP/s over 3.35 TB/s) and
// in bf16 on the tensor cores (989 TFLOP/s, three passes a product for f32
// blocks).
//
// Walk (both bodies): a CTA owns a group of kWarps units x one column tile,
// where a unit is 8 rows of one block-row (bm = 8 has one unit a block-row)
// and a warp owns one unit.  The CTA walks K in ascending chunks of whole
// block-columns, kStages chunks of x in flight in a ring of shared-memory
// stages; a stage's `full` mbarrier completes when its chunk has landed, so
// an x value fetched once serves every block-row of the group that keeps
// its block-column (1 - 0.75^16 = 99 % of a chunk's block-columns at keep
// 0.25).  There is no producer warp: the last warp to finish reading a
// stage stages the chunk kStages further on into it (a 17th warp would cap
// the registers at 96).  Each warp keeps a
// cursor into its block-row's kept blocks and, for each chunk, walks those
// that fall inside it: chunks ascend and each block-row's live block_idx
// is strictly ascending (bsr_from_dense's np.nonzero), so a block-row's
// blocks are visited with nb ascending, a prefix walk over block_idx.  The
// wrapper states that precondition and trusts it, as it trusts the index
// bounds.  Padded blocks (nb >= block_nnz[i]) are never read; a block-row
// with no kept block writes zeros; every output element is stored once (no
// atomics), so the wrapper allocates the output with torch.empty and a
// launch equals the next bit for bit.  Batch: a batch element is a column
// tile of its own in the grid; element b reads x + b * K * N and writes
// out + b * n_rb * bm * N (int64 offsets), so batched equals looped bit for
// bit, and the unbatched launch is batch = 1.
//
// The SIMT body.  Each output element takes its products from 0.0f with nb
// ascending, then kk ascending, through __fmul_rn and __fadd_rn (no FMA
// contraction, no TF32: one thread owns each output element), the plain
// PyTorch version's order, so the two agree bit for bit; a bf16 operand is
// widened with __bfloat162float (exact) where it is read.  A lane holds an
// 8-row x kVec-column register tile; the block's weights reach shared
// memory as 8 x 8 pieces, transposed to [kk][row], the next piece's loaded
// into registers while the current one is summed, two pieces alternating in
// each warp's buffer.  A multiply-add is two instructions, so the floor of
// this order is twice the operation bound: 4.6 ms for granite-20b's gate at
// a prefill of 2048 tokens, where it takes 6.4 ms (the products themselves,
// then the shared-memory loads feeding them; benchmarks/torch_bsr_shapes.py
// on the H100, 700 W).  The generic instance (1 <= bk <= 256, any bm, split
// into slabs of 8 rows and pieces of 8 kk, the last ones zero-padded in the
// rows and cut short in kk) takes 32 columns a CTA, one a lane, and stages
// x by the electing warp's lanes (zero-filled past N): f32 with 4-byte
// cp.async gathers, bf16 with plain 2-byte loads and stores (a row of bf16
// x may start on 2 bytes), then an arrival that releases them.
//
// The tensor-core body.  It computes out^T = x^T * W^T with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: M is 16 tokens, N the 8 rows
// of the warp's block-row, K two kept blocks of it that fall in the same
// staged chunk (a block left over in a chunk takes m16n8k8; a block is
// never paired with zeros, whose x rows may hold an infinity: 0 x inf is
// NaN).  The other orientation (M = block rows) would pad 8 rows to 16 or
// mix two block-rows' patterns.  A warp's 256 (or 128) columns are 16 (8)
// m-tiles, 4 f32 accumulators each.
// - B from device memory: lane (g, t) = (lane / 4, lane % 4) needs
//   W[g][2t], W[g][2t + 1], the 2 * lane-th pair of a block's 64 contiguous
//   weights: one coalesced load a block a warp (4 bytes a lane in bf16, 8
//   in f32), kAhead blocks of weights and indices ahead in registers.
// - f32 blocks: each weight is the exact sum of three bf16 parts (split3:
//   hi its word's top 16 bits, mid the top 16 of w - hi, lo the rest; exact
//   for |w| >= 2^-110 and 0), three MMAs on one A fragment, the smallest
//   part first, into the same accumulators.  Where every lane's mid (lo)
//   parts of a step are zero (bf16-exact weights, integers) that pass is
//   skipped: it saves two thirds of the work there and keeps an infinite x
//   under such weights from meeting a zero part (0 x inf = NaN where the
//   plain version gives the infinity; under a weight that is bf16-exact
//   beside others that are not, that difference remains: ROADMAP C22).
// - A by ldmatrix.x4.trans from the staged x: each 8 x 8 submatrix is 8 x
//   rows (one block's kk) x 8 tokens and each lane gives one row's address,
//   so the two blocks' rows are gathered for free.  x is staged by TMA with
//   the 128-byte swizzle, a chunk as kCols / 64 boxes of 64 columns (128
//   bytes) x the chunk's rows, and the ldmatrix addresses XOR the 16-byte
//   piece with the row mod 8: unswizzled, the 8 rows an ldmatrix reads fall
//   on the same banks and the launch takes 5.5 ms instead of 1.0 (ablation
//   no_swizzle).
// - A step is straight-line code per pass count: a region's 4 m-tiles'
//   fragments, then a pass a part over them, so no MMA waits for the one
//   before and the next region's ldmatrix issues under this one's MMAs.
// - The store: the C fragment is [token][row] and out is [row][token], so
//   64 columns at a time go through a warp's 8 x 72 staging in shared
//   memory, each sum rounded once to bf16 there, and leave as 16-byte row
//   pieces.
// Numbers: not bit for bit the plain version any more (the MMA's order, and
// its truncating additions), but within the bound derived in
// kernels.bsr_mma_tolerance:
//   |kernel - plain| <= (5m/2 + n + 2) * 1.01 * 2^-24 * S + (2m + n) * 2^-149
//   (+ one bf16 ulp of the larger of the two outputs),
// n the element's products, m = 3n (f32 blocks) or n (bf16), S the sum of
// |w| |x| over its products (|w| >= 2^-110 for f32 blocks).  Integer values
// (every sum below 2^24) are exact in any order: the f64 product rounded
// once to bf16.  __launch_bounds__(512, 1) stays: 16 warps share a staged
// chunk, the 256-column instances use up to 128 registers and no spills.
// On the H100 (700 W; benchmarks/torch_bsr_shapes.py, the parent's SIMT
// body in the same run) granite-20b's gate at a prefill of 2048 tokens
// takes 1.44 ms with f32 blocks (6.36 on the SIMT body; bound 0.469) and
// 1.02 with bf16 blocks (6.20; bound 0.156); K5-b at the FFN's batch (x [8,
// 6144, 128]) 0.96 and 0.73 (3.39 and 3.27).  What holds it, by that
// script's ablations: the MMAs cost about 0.2 ms a pass (hi alone, f32
// blocks: 1.07); staging no x saves 0.03-0.12 ms, A from registers in
// place of ldmatrix 0.10 with bf16 blocks and nothing with f32 ones, and
// storing from the lanes in place of the staged rows is slower.  So about
// 0.8 ms of a launch is the walk itself, which no one ablation removes:
// per step a warp's window, pairing and 16 dependent ldmatrix-MMA pairs,
// with 4 warps a scheduler to hide their latency, and per chunk (about 2
// steps a warp at keep 0.25) the ring's barrier.  A wider N (two
// block-rows a warp: more independent MMAs a step, half the x read from
// L2) or wgmma is the next step.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;            // warps of a CTA, one unit each
constexpr int kStages = 3;            // chunks of x in flight
constexpr int kStageFloats = 16384;   // a stage holds this many floats' bytes
constexpr int kSlab = 8;              // rows of a unit, kk of a piece
constexpr int kThreads = kWarps * 32;
static_assert(kStageFloats >= 256 * 32 && kStageFloats % 2048 == 0,
              "a stage holds 256 rows of 32 columns and whole 8 x 8 chunks");

struct Smem {
  float x[kStages][kStageFloats];     // [chunk row][column], of x's type
  float w[kWarps][2][kSlab * kSlab];  // a warp's pieces, [kk][row]
  unsigned long long full[kStages];   // the stage holds its chunk
  int done[kStages];                  // warps done with the stage so far
};

// an operand's value as f32: a bf16 one widened by __bfloat162float (exact)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a weight read through the read-only path, in its own type: it is
// widened only where it is stored to shared memory, a piece later, so that
// no instruction waits for the load while the current piece is summed
__device__ __forceinline__ float load_weight(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ __nv_bfloat16 load_weight(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

// +0 in an operand's type
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(n)
               : "memory");
}

// an arrival that also expects `bytes` of bulk copies on this phase
__device__ __forceinline__ void bar_arrive_expect(unsigned long long* bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// an arrival once this thread's cp.async gathers so far have landed
__device__ __forceinline__ void bar_arrive_gathers(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// an arrival that releases this thread's stores to shared memory so far
// (an arrival's default semantics: release, at the CTA's scope)
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the phase of parity `parity` to complete; ten seconds of waiting
// means a broken count, and traps rather than hanging the card
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  uint64_t t0 = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if ((polls & 1023u) == 1023u) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      if (t0 == 0) t0 = t;
      if (t - t0 > 10000000000ull) __trap();
    }
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the box of `map` at (c0, c1, c2) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// the chunks [ch_lo, ch_hi) of kc block-columns that the kept blocks of
// units u0 ... u0 + kWarps - 1 fall in: from their least first block to
// their greatest last block (block_idx ascends in every block-row)
__device__ __forceinline__ void group_chunks(const int* block_idx,
                                             const int* block_nnz,
                                             int max_nb, int u0, int slabs,
                                             int n_units, int kc, int lane,
                                             int& ch_lo, int& ch_hi) {
  int lo = 0x7fffffff, hi = -1;
  if (lane < kWarps) {
    const int u = u0 + lane;
    if (u < n_units) {
      const int64_t row = static_cast<int64_t>(u / slabs) * max_nb;
      const int nnz = block_nnz[u / slabs];
      if (nnz > 0) {
        lo = block_idx[row];
        hi = block_idx[row + nnz - 1];
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  ch_lo = hi < 0 ? 0 : lo / kc;
  ch_hi = hi < 0 ? 0 : hi / kc + 1;
}

// this warp is done reading a stage (`done` its count): whether it is the
// last warp of the CTA to be, the one that stages the next chunk there
__device__ __forceinline__ bool last_reader(int* done, int lane) {
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    __threadfence_block();
    last = atomicAdd(done, 1) % kWarps == kWarps - 1;
    if (last) __threadfence_block();
  }
  return __shfl_sync(0xffffffffu, last, 0) != 0;
}

// 4 bytes, or zeros where `live` is false
__device__ __forceinline__ void gather4(void* dst, const void* src,
                                        bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// a lane's kVec consecutive x values of a staged row, in 16-byte loads
template <int kVec>
__device__ __forceinline__ void read_x(const float* xs, float (&xv)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    const float4 x4 = *reinterpret_cast<const float4*>(xs + 4 * q);
    xv[4 * q] = x4.x;
    xv[4 * q + 1] = x4.y;
    xv[4 * q + 2] = x4.z;
    xv[4 * q + 3] = x4.w;
  }
}
// a lane's kVec consecutive sums of one output row, in 16-byte stores
template <int kVec>
__device__ __forceinline__ void write_out(float* o, const float (&a)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    reinterpret_cast<float4*>(o)[q] =
        make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}
// kVec columns a lane: 4 or 8 for 8 x 8 blocks (x staged by TMA), 1 for any
// block shape (bm_rt, bk_rt; x staged by the electing warp's lanes); TW the
// blocks' type, TX x's and the output's (float or __nv_bfloat16)
template <int kVec, typename TW, typename TX>
__global__ void __launch_bounds__(kThreads, 1)
bsr_kernel(const __grid_constant__ CUtensorMap x_map,
           const int* __restrict__ block_idx,
           const int* __restrict__ block_nnz,
           const TW* __restrict__ blocks, int n_rb, int max_nb,
           int bm_rt, int bk_rt, const TX* __restrict__ x, int k_dim,
           int n, int n_groups, int n_ct, TX* __restrict__ out) {
  constexpr bool kFixed = kVec > 1;
  constexpr int kCols = 32 * kVec;       // columns a CTA
  const int bm = kFixed ? 8 : bm_rt;
  const int bk = kFixed ? 8 : bk_rt;
  const int slabs = kFixed ? 1 : (bm + kSlab - 1) / kSlab;
  const int pieces = kFixed ? 1 : (bk + kSlab - 1) / kSlab;
  // block-columns a chunk: a stage holds kStageFloats * 4 bytes of x
  const int kc =
      kStageFloats * 4 / static_cast<int>(sizeof(TX)) / kCols / bk;
  const int chunk_rows = kc * bk;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  auto stage = [&](int s) { return reinterpret_cast<TX*>(sm.x[s]); };

  // this CTA's batch element, column tile and group, the groups of a tile
  // side by side
  const int tile = blockIdx.x / n_groups;
  const int group = blockIdx.x % n_groups;
  const int elem = tile / n_ct;
  const int col0 = tile % n_ct * kCols;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_units = n_rb * slabs;
  const int cl = lane * kVec;   // this lane's first column in the tile

  int ch_lo, ch_hi;
  group_chunks(block_idx, block_nnz, max_nb, group * kWarps, slabs, n_units,
               kc, lane, ch_lo, ch_hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], kFixed ? 1 : 32);
      sm.done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c into stage s, by one whole warp
  auto stage_chunk = [&](int c, int s) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if constexpr (kFixed) {
      if (lane == 0) {
        bar_arrive_expect(&sm.full[s], kStageFloats * 4);
        tma_load_3d(sm.x[s], &x_map, col0, c * chunk_rows, elem,
                    &sm.full[s]);
      }
    } else {
      const int k0 = c * chunk_rows;
      const int rows = min(chunk_rows, k_dim - k0);
      const bool live = col0 + lane < n;
      const TX* src =
          x + (static_cast<int64_t>(elem) * k_dim + k0) * n + col0 + lane;
      TX* dst = stage(s) + lane;
      if constexpr (sizeof(TX) == 4) {
        for (int r = 0; r < rows; ++r) {
          gather4(dst + r * kCols, live ? src + static_cast<int64_t>(r) * n
                                        : x, live);
        }
        bar_arrive_gathers(&sm.full[s]);
      } else {
        const unsigned short* src16 =
            reinterpret_cast<const unsigned short*>(src);
        unsigned short* dst16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll 8
        for (int r = 0; r < rows; ++r) {
          dst16[r * kCols] =
              live ? src16[static_cast<int64_t>(r) * n] : (unsigned short)0;
        }
        bar_arrive(&sm.full[s]);
      }
    }
  };
  if (warp == 0) {
    for (int c = ch_lo; c < min(ch_hi, ch_lo + kStages); ++c) {
      stage_chunk(c, c - ch_lo);
    }
  }

  // warp's unit u: block-row i, rows slab * 8 ... slab * 8 + 7
  const int u = group * kWarps + warp;
  const bool has = u < n_units;
  const int i = has ? u / slabs : 0;
  const int slab = has ? u % slabs : 0;
  const int nnz = has ? block_nnz[i] : 0;
  const int* idx_row = block_idx + static_cast<int64_t>(i) * max_nb;
  const TW* w_row = blocks + static_cast<int64_t>(i) * max_nb * bm * bk;
  // this lane's two weights of a piece: rows r_a and r_a + 4, column kk_l
  const int r_a = lane >> 3;
  const int kk_l = lane & 7;

  auto load_piece = [&](int nb, int p, TW& w0, TW& w1) {
    const TW* b = w_row + static_cast<int64_t>(nb) * bm * bk;
    if constexpr (kFixed) {
      w0 = load_weight(b + lane);
      w1 = load_weight(b + 32 + lane);
    } else {
      const int ra = slab * kSlab + r_a;
      const int kk = p * kSlab + kk_l;
      w0 = ra < bm && kk < bk ? load_weight(b + ra * bk + kk) : zero_of<TW>();
      w1 = ra + 4 < bm && kk < bk ? load_weight(b + (ra + 4) * bk + kk)
                                  : zero_of<TW>();
    }
  };

  float acc[kSlab][kVec];
#pragma unroll
  for (int r = 0; r < kSlab; ++r) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[r][v] = 0.0f;
  }
  int nb = 0, p = 0, buf = 0;
  int cur = nnz > 0 ? idx_row[0] : 0;   // block_idx of block nb
  TW w0 = zero_of<TW>(), w1 = w0;       // the weights of piece (nb, p)
  if (nnz > 0) load_piece(0, 0, w0, w1);

  for (int c = ch_lo, uu = 0; c < ch_hi; ++c, ++uu) {
    const int s = uu % kStages;
    bar_wait(&sm.full[s], (uu / kStages) & 1);
    const int c_end = (c + 1) * kc;
    const TX* xe = stage(s) + cl;
    while (nb < nnz && cur < c_end) {
      float* wb = sm.w[warp][buf];
      wb[kk_l * kSlab + r_a] = widen(w0);
      wb[kk_l * kSlab + r_a + 4] = widen(w1);
      __syncwarp();
      const TX* xs = xe + ((cur - c * kc) * bk + p * kSlab) * kCols;
      const int nkk = kFixed ? kSlab : min(kSlab, bk - p * kSlab);
      // the next piece: its block index and weights, loaded while this
      // piece is summed
      if (++p == pieces) {
        p = 0;
        if (++nb < nnz) cur = idx_row[nb];
      }
      if (nb < nnz) load_piece(nb, p, w0, w1);
      const float4* w4 = reinterpret_cast<const float4*>(wb);
#pragma unroll
      for (int kk = 0; kk < kSlab; ++kk) {
        if (!kFixed && kk >= nkk) break;
        const float4 lo4 = w4[2 * kk];
        const float4 hi4 = w4[2 * kk + 1];
        const float wr[kSlab] = {lo4.x, lo4.y, lo4.z, lo4.w,
                                 hi4.x, hi4.y, hi4.z, hi4.w};
        float xv[kVec];
        if constexpr (kFixed) {
          read_x<kVec>(xs + kk * kCols, xv);
        } else {
          xv[0] = widen(xs[kk * kCols]);
        }
#pragma unroll
        for (int r = 0; r < kSlab; ++r) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            acc[r][v] = __fadd_rn(acc[r][v], __fmul_rn(wr[r], xv[v]));
          }
        }
      }
      buf ^= 1;
    }
    // done with the stage: the last warp to finish it stages the chunk
    // kStages further on there
    if (last_reader(&sm.done[s], lane) && c + kStages < ch_hi) {
      __syncwarp();
      stage_chunk(c + kStages, s);
    }
  }
  if constexpr (!kFixed) asm volatile("cp.async.wait_all;\n" ::: "memory");

  const int col = col0 + cl;
  if (has && col < n) {
    TX* o = out + static_cast<int64_t>(elem) * n_rb * bm * n + col;
#pragma unroll
    for (int r = 0; r < kSlab; ++r) {
      const int row = slab * kSlab + r;
      if (row < bm) {
        TX* orow = o + (static_cast<int64_t>(i) * bm + row) * n;
        if constexpr (kFixed) {
          write_out<kVec>(orow, acc[r]);
        } else {
          store_one(orow, acc[r][0]);
        }
      }
    }
  }
}

// ---- the tensor-core body: 8 x 8 blocks on bf16 x ------------------------

constexpr int kOutPitch = 72;   // bf16 a row of a warp's output staging
constexpr int kAhead = 4;       // blocks of a warp's window of weights
constexpr int kNone = 0x7fffffff;   // block_idx past a block-row's nnz

struct SmemMma {
  // a stage: kCols / 64 regions [chunk row][64 columns] of bf16, each
  // staged by one TMA copy with the 128-byte swizzle
  unsigned char x[kStages][kStageFloats * 4];
  __nv_bfloat16 o[kWarps][kSlab][kOutPitch];   // a warp's 8 rows x 64 columns
  unsigned long long full[kStages];
  int done[kStages];
};

// the B fragment words of a lane in one block: W[g][2t], W[g][2t + 1]
// (g = lane / 4, t = lane % 4), the 2 * lane-th pair of the block's 64
// weights; one coalesced load a block a warp
__device__ __forceinline__ float2 load_frag(const float* b, int lane) {
  return __ldg(reinterpret_cast<const float2*>(b) + lane);
}
__device__ __forceinline__ unsigned load_frag(const __nv_bfloat16* b,
                                              int lane) {
  return __ldg(reinterpret_cast<const unsigned*>(b) + lane);
}

// An f32 weight as three bf16 parts with hi + mid + lo == w exactly (|w| >=
// 2^-110 or 0; below, lo drops the bits under bf16's 2^-133): hi the top 16
// bits of w's word (a truncation, so no part overflows), mid the top 16 of
// r = w - hi (exact), lo = r - mid (exact, at most 8 significant bits).  An
// infinite or NaN weight keeps its value in hi (a NaN quiet) and zeros in
// mid and lo.
__device__ __forceinline__ void split3(float w, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  const unsigned u = __float_as_uint(w);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    hi = (u >> 16) | ((u & 0x007fffffu) ? 0x40u : 0u);
    mid = lo = 0;
    return;
  }
  const unsigned h = u & 0xffff0000u;
  const float r = __fsub_rn(w, __uint_as_float(h));
  const unsigned m = __float_as_uint(r) & 0xffff0000u;
  hi = h >> 16;
  mid = m >> 16;
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(m))) >> 16;
}

// a lane's B words of one block in each part: [0] hi, [1] mid, [2] lo
__device__ __forceinline__ void parts(float2 w, unsigned (&p)[3]) {
  unsigned h0, m0, l0, h1, m1, l1;
  split3(w.x, h0, m0, l0);
  split3(w.y, h1, m1, l1);
  p[0] = h0 | h1 << 16;
  p[1] = m0 | m1 << 16;
  p[2] = l0 | l1 << 16;
}
__device__ __forceinline__ void parts(unsigned w, unsigned (&p)[3]) {
  p[0] = w;
  p[1] = p[2] = 0;
}

// four 8 x 8 bf16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_t(unsigned (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&a)[2], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(a[0]), "=r"(a[1])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, tokens x kk of two blocks) * b (16 x 8, kk x rows)
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16 x 8, tokens x kk of one block) * b (8 x 8)
__device__ __forceinline__ void mma_k8(float (&d)[4], const unsigned (&a)[2],
                                       unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// One step of a warp on all its kTiles m16 tiles: the A fragments of a
// region's 4 m-tiles (two blocks' x rows: ldmatrix x4, k16; one block's:
// x2, k8), then kPasses MMAs on each, a pass a part, the smallest first
// (lo, mid, hi), into the same accumulators.  Straight-line code, so that
// the next region's ldmatrix is issued under this region's MMAs.
template <int kPasses, bool kPair, int kTiles, int kRegionBytes>
__device__ __forceinline__ void mma_step(float (&acc)[kTiles][4],
                                         unsigned base,
                                         const unsigned (&off)[4],
                                         const unsigned (&pa)[3],
                                         const unsigned (&pb)[3]) {
#pragma unroll
  for (int m0 = 0; m0 < kTiles; m0 += 4) {
    unsigned a[4][kPair ? 4 : 2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (kPair) {
        ldsm_x4_t(a[q], base + (m0 >> 2) * kRegionBytes + off[q]);
      } else {
        ldsm_x2_t(a[q], base + (m0 >> 2) * kRegionBytes + off[q]);
      }
    }
#pragma unroll
    for (int p = kPasses - 1; p >= 0; --p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kPair) {
          mma_k16(acc[m0 + q], a[q], pa[p], pb[p]);
        } else {
          mma_k8(acc[m0 + q], a[q], pa[p]);
        }
      }
    }
  }
}

// whether any lane's part words of this step are not all zeros (+-0)
__device__ __forceinline__ bool any_part(unsigned a, unsigned b) {
  return __any_sync(0xffffffffu, ((a | b) & 0x7fff7fffu) != 0u) != 0;
}

// kTiles m16 tiles of tokens a warp (16: 256 columns a CTA, 8: 128); TW the
// blocks' type (f32: three passes a step, one a part; bf16: one); x and
// the output bf16
template <int kTiles, typename TW>
__global__ void __launch_bounds__(kThreads, 1)
bsr_mma_kernel(const __grid_constant__ CUtensorMap x_map,
               const int* __restrict__ block_idx,
               const int* __restrict__ block_nnz,
               const TW* __restrict__ blocks, int n_rb, int max_nb, int n,
               int n_groups, int n_ct, __nv_bfloat16* __restrict__ out) {
  constexpr bool kSplit = sizeof(TW) == 4;
  constexpr int kCols = 16 * kTiles;
  constexpr int kRegions = kCols / 64;
  constexpr int kRegionBytes = kStageFloats * 4 / kRegions;
  constexpr int kChunkRows = kRegionBytes / 128;
  constexpr int kc = kChunkRows / kSlab;   // block-columns a chunk
  static_assert(kChunkRows <= 256, "a TMA box has at most 256 rows");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  SmemMma& sm = *reinterpret_cast<SmemMma*>(smem_raw);

  // the groups of a tile side by side, as in the SIMT body (the tiles of a
  // group side by side, sharing its weights in L2, measured the same)
  const int tile = blockIdx.x / n_groups;
  const int group = blockIdx.x % n_groups;
  const int elem = tile / n_ct;
  const int col0 = tile % n_ct * kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the tile's regions with a column of x: the others are not staged
  const int live_regions = min(kRegions, (n - col0 + 63) / 64);

  int ch_lo, ch_hi;
  group_chunks(block_idx, block_nnz, max_nb, group * kWarps, 1, n_rb, kc,
               lane, ch_lo, ch_hi);

  if (threadIdx.x == 0) {
    // the swizzle below is the address's bits 4-6 XOR bits 7-9
    if (smem_addr(sm.x) % 1024 != 0) __trap();
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);
      sm.done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c into stage s: one TMA copy a live region, by one whole warp
  auto stage_chunk = [&](int c, int s) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) {
      bar_arrive_expect(&sm.full[s], live_regions * kRegionBytes);
      for (int r = 0; r < live_regions; ++r) {
        tma_load_3d(sm.x[s] + r * kRegionBytes, &x_map, col0 + 64 * r,
                    c * kChunkRows, elem, &sm.full[s]);
      }
    }
  };
  if (warp == 0) {
    for (int c = ch_lo; c < min(ch_hi, ch_lo + kStages); ++c) {
      stage_chunk(c, c - ch_lo);
    }
  }

  // the warp's block-row i
  const int i = group * kWarps + warp;
  const bool has = i < n_rb;
  const int nnz = has ? block_nnz[i] : 0;
  const int* idx_row = block_idx + static_cast<int64_t>(i) * max_nb;
  const TW* w_row = blocks + static_cast<int64_t>(i) * max_nb * 64;

  // ldmatrix: lane l addresses row l % 8 of its block's 8 x rows, in the
  // m-tile's first (l / 8 even) or second 8 tokens; the 16-byte piece of a
  // 128-byte row sits at its index XOR the row's index mod 8 (the swizzle)
  const int r8 = lane & 7;
  const unsigned key = static_cast<unsigned>(((lane >> 3) & 1) ^ r8);
  unsigned off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) off[q] = ((static_cast<unsigned>(q) << 1) ^ key) << 4;

  using Frag = decltype(load_frag(blocks, 0));
  float acc[kTiles][4];
#pragma unroll
  for (int mt = 0; mt < kTiles; ++mt) {
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[mt][v] = 0.0f;
  }
  // blocks nb ... nb + kAhead - 1: their block_idx (kNone past nnz) and
  // weights, loaded kAhead - 2 blocks before their step at least, so that
  // a load from device memory has a few steps to land
  int nb = 0;
  int bi[kAhead];
  Frag bw[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    bi[j] = kNone;
    bw[j] = Frag{};
    if (j < nnz) {
      bi[j] = idx_row[j];
      bw[j] = load_frag(w_row + j * 64, lane);
    }
  }

  for (int c = ch_lo, uu = 0; c < ch_hi; ++c, ++uu) {
    const int s = uu % kStages;
    bar_wait(&sm.full[s], (uu / kStages) & 1);
    const int c_end = (c + 1) * kc;
    const unsigned sx = smem_addr(sm.x[s]);
    while (bi[0] < c_end) {
      // a step: blocks nb and nb + 1 as one k16 product where both fall in
      // this chunk, else block nb alone as a k8 product
      const bool pair = bi[1] < c_end;
      const int bc = (pair && lane >= 16 ? bi[1] : bi[0]) - c * kc;
      const unsigned base = sx + static_cast<unsigned>(bc * kSlab + r8) * 128u;
      unsigned pa[3], pb[3];
      parts(bw[0], pa);
      parts(bw[1], pb);
      if (!pair) pb[0] = pb[1] = pb[2] = 0;
      const bool mid = kSplit && any_part(pa[1], pb[1]);
      const bool low = kSplit && any_part(pa[2], pb[2]);
      // the window moves on by the step's blocks, and the blocks now at its
      // end are loaded while this step is summed
      const int step = pair ? 2 : 1;
      nb += step;
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (pair) {
          bi[j] = j + 2 < kAhead ? bi[j + 2] : kNone;
          if (j + 2 < kAhead) bw[j] = bw[j + 2];
        } else {
          bi[j] = j + 1 < kAhead ? bi[j + 1] : kNone;
          if (j + 1 < kAhead) bw[j] = bw[j + 1];
        }
      }
#pragma unroll
      for (int j = kAhead - 2; j < kAhead; ++j) {
        const int b = nb + j;
        if ((pair || j == kAhead - 1) && b < nnz) {
          bi[j] = idx_row[b];
          bw[j] = load_frag(w_row + static_cast<int64_t>(b) * 64, lane);
        }
      }
      // the parts' passes: lo, mid and hi where some lane's lo part is not
      // 0, mid and hi where only mid parts are (lo != 0 has mid != 0), hi
      // alone where the weights are bf16-exact, as bf16 blocks are; the
      // m-tiles past N compute what no lane stores
      const int passes = low ? 3 : mid ? 2 : 1;
      if (pair) {
        if (passes == 3) {
          mma_step<3, true, kTiles, kRegionBytes>(acc, base, off, pa, pb);
        } else if (passes == 2) {
          mma_step<2, true, kTiles, kRegionBytes>(acc, base, off, pa, pb);
        } else {
          mma_step<1, true, kTiles, kRegionBytes>(acc, base, off, pa, pb);
        }
      } else {
        if (passes == 3) {
          mma_step<3, false, kTiles, kRegionBytes>(acc, base, off, pa, pb);
        } else if (passes == 2) {
          mma_step<2, false, kTiles, kRegionBytes>(acc, base, off, pa, pb);
        } else {
          mma_step<1, false, kTiles, kRegionBytes>(acc, base, off, pa, pb);
        }
      }
    }
    if (last_reader(&sm.done[s], lane) && c + kStages < ch_hi) {
      __syncwarp();
      stage_chunk(c + kStages, s);
    }
  }

  // the store: lane (g, t) holds rows 2t, 2t + 1 of tokens g and g + 8 of
  // each m-tile; 64 columns at a time go through the warp's staging, each
  // sum rounded once to bf16 there, and leave as 16-byte row pieces
  if (!has) return;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16(*o)[kOutPitch] = sm.o[warp];
  __nv_bfloat16* orow =
      out + (static_cast<int64_t>(elem) * n_rb + i) * kSlab * n;
#pragma unroll
  for (int r = 0; r < kRegions; ++r) {
    if (r < live_regions) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mt = 4 * r + q, tok = 16 * q + g;
        o[2 * t][tok] = __float2bfloat16_rn(acc[mt][0]);
        o[2 * t + 1][tok] = __float2bfloat16_rn(acc[mt][1]);
        o[2 * t][tok + 8] = __float2bfloat16_rn(acc[mt][2]);
        o[2 * t + 1][tok + 8] = __float2bfloat16_rn(acc[mt][3]);
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int piece = lane + 32 * h, row = piece >> 3, j = piece & 7;
        const int col = col0 + 64 * r + 8 * j;
        if (col < n) {
          *reinterpret_cast<uint4*>(orow + static_cast<int64_t>(row) * n +
                                    col) =
              *reinterpret_cast<const uint4*>(&o[row][8 * j]);
        }
      }
      __syncwarp();
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The launch's shape for these operands; repro_bsr_layout reports it
struct Layout {
  int vec;          // a tile's columns / 32: 8 or 4 (the 8 x 8 instances), 1
  int mma;          // 1: the tensor-core body (8 x 8 blocks on bf16 x)
  int chunk;        // block-columns a chunk
  int slabs;        // units a block-row
  int64_t groups;   // groups of kWarps units, the CTAs of one tile
  int64_t tiles;    // column tiles x batch elements
};

// x_size: bytes of one value of x (4 for f32, 2 for bf16)
Layout choose_layout(int n_rb, int bm, int bk, int n, int batch,
                     bool aligned, int x_size) {
  Layout l;
  l.slabs = (bm + kSlab - 1) / kSlab;
  l.groups = (static_cast<int64_t>(n_rb) * l.slabs + kWarps - 1) / kWarps;
  // TMA wants a row of x to be a multiple of 16 bytes
  const bool fixed = bm == 8 && bk == 8 &&
                     static_cast<int64_t>(n) * x_size % 16 == 0 && aligned;
  l.vec = !fixed ? 1 : n % 256 == 0 ? 8 : 4;
  l.mma = fixed && x_size == 2;
  l.chunk = kStageFloats * 4 / x_size / (32 * l.vec) / bk;
  const int cols = 32 * l.vec;   // columns a tile
  l.tiles = static_cast<int64_t>((n + cols - 1) / cols) * batch;
  return l;
}

template <int kVec, typename TW, typename TX>
cudaError_t launch(const Layout& l, const void* block_idx,
                   const void* block_nnz, const void* blocks, int n_rb,
                   int max_nb, int bm, int bk, const void* x, int k_dim,
                   int n, int batch, void* out, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      bsr_kernel<kVec, TW, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(Smem));
  if (attr != cudaSuccess) return attr;
  CUtensorMap map = {};
  if (kVec > 1) {
    // x [B, K, N]; a box is the tile's columns x a chunk's rows of one
    // element, kStageFloats * 4 bytes
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k_dim),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(n) * sizeof(TX),
        static_cast<cuuint64_t>(n) * k_dim * sizeof(TX)};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(32 * kVec),
                               static_cast<cuuint32_t>(l.chunk * bk), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&map,
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               3, const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const int64_t ctas = l.groups * l.tiles;
  if (ctas > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int n_ct = (n + 32 * kVec - 1) / (32 * kVec);
  bsr_kernel<kVec, TW, TX><<<static_cast<unsigned>(ctas), kThreads,
                             sizeof(Smem), stream>>>(
      map, static_cast<const int*>(block_idx),
      static_cast<const int*>(block_nnz), static_cast<const TW*>(blocks),
      n_rb, max_nb, bm, bk, static_cast<const TX*>(x), k_dim, n,
      static_cast<int>(l.groups), n_ct, static_cast<TX*>(out));
  return cudaSuccess;
}

template <int kTiles, typename TW>
cudaError_t launch_mma(const Layout& l, const void* block_idx,
                       const void* block_nnz, const void* blocks, int n_rb,
                       int max_nb, const void* x, int k_dim, int n, int batch,
                       void* out, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      bsr_mma_kernel<kTiles, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(SmemMma));
  if (attr != cudaSuccess) return attr;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // x [B, K, N] in bf16; a box is 64 columns (128 bytes, the swizzle's
  // span) x a chunk's rows of one element
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(k_dim),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                 static_cast<cuuint64_t>(n) * k_dim * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(l.chunk * kSlab),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap map = {};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const int64_t ctas = l.groups * l.tiles;
  if (ctas > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int n_ct = (n + 16 * kTiles - 1) / (16 * kTiles);
  bsr_mma_kernel<kTiles, TW><<<static_cast<unsigned>(ctas), kThreads,
                               sizeof(SmemMma), stream>>>(
      map, static_cast<const int*>(block_idx),
      static_cast<const int*>(block_nnz), static_cast<const TW*>(blocks),
      n_rb, max_nb, n, static_cast<int>(l.groups), n_ct,
      static_cast<__nv_bfloat16*>(out));
  return cudaSuccess;
}

// the instance for the dtype codes (0 f32, 1 bf16) of the blocks and x
template <int kVec>
cudaError_t launch_typed(int w_dtype, int x_dtype, const Layout& l,
                         const void* block_idx, const void* block_nnz,
                         const void* blocks, int n_rb, int max_nb, int bm,
                         int bk, const void* x, int k_dim, int n, int batch,
                         void* out, cudaStream_t s) {
  if (w_dtype == 0 && x_dtype == 0) {
    return launch<kVec, float, float>(l, block_idx, block_nnz, blocks, n_rb,
                                      max_nb, bm, bk, x, k_dim, n, batch,
                                      out, s);
  }
  if (w_dtype == 1 && x_dtype == 0) {
    return launch<kVec, __nv_bfloat16, float>(l, block_idx, block_nnz,
                                              blocks, n_rb, max_nb, bm, bk,
                                              x, k_dim, n, batch, out, s);
  }
  // bf16 x on 8 x 8 blocks takes the tensor-core body (launch_mma)
  if constexpr (kVec == 1) {
    if (w_dtype == 0 && x_dtype == 1) {
      return launch<kVec, float, __nv_bfloat16>(l, block_idx, block_nnz,
                                                blocks, n_rb, max_nb, bm, bk,
                                                x, k_dim, n, batch, out, s);
    }
    if (w_dtype == 1 && x_dtype == 1) {
      return launch<kVec, __nv_bfloat16, __nv_bfloat16>(
          l, block_idx, block_nnz, blocks, n_rb, max_nb, bm, bk, x, k_dim,
          n, batch, out, s);
    }
  }
  return cudaErrorInvalidValue;
}

int x_size(int x_dtype) { return x_dtype == 1 ? 2 : 4; }

}  // namespace

// The dtype codes (0 f32, 1 bf16) of the blocks and of x (and the output)
// come last, so that a library built from a source before them still takes
// f32 launches through these arguments.
extern "C" int repro_bsr_launch(const void* block_idx, const void* block_nnz,
                                const void* blocks, int n_rb, int max_nb,
                                int bm, int bk, const void* x, int k_dim,
                                int n, int batch, void* out, void* stream,
                                int w_dtype, int x_dtype) {
  cudaError_t err = cudaSuccess;
  if ((w_dtype != 0 && w_dtype != 1) || (x_dtype != 0 && x_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rb > 0 && n > 0 && batch > 0 && bm > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout l = choose_layout(
        n_rb, bm, bk, n, batch,
        k_dim > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(blocks) % 16 == 0,
        x_size(x_dtype));
    if (l.mma) {
      err = w_dtype == 0
                ? (l.vec == 8 ? launch_mma<16, float>
                              : launch_mma<8, float>)(
                      l, block_idx, block_nnz, blocks, n_rb, max_nb, x,
                      k_dim, n, batch, out, s)
                : (l.vec == 8 ? launch_mma<16, __nv_bfloat16>
                              : launch_mma<8, __nv_bfloat16>)(
                      l, block_idx, block_nnz, blocks, n_rb, max_nb, x,
                      k_dim, n, batch, out, s);
    } else if (l.vec == 8) {
      err = launch_typed<8>(w_dtype, x_dtype, l, block_idx, block_nnz,
                            blocks, n_rb, max_nb, bm, bk, x, k_dim, n, batch,
                            out, s);
    } else if (l.vec == 4) {
      err = launch_typed<4>(w_dtype, x_dtype, l, block_idx, block_nnz,
                            blocks, n_rb, max_nb, bm, bk, x, k_dim, n, batch,
                            out, s);
    } else {
      err = launch_typed<1>(w_dtype, x_dtype, l, block_idx, block_nnz,
                            blocks, n_rb, max_nb, bm, bk, x, k_dim, n, batch,
                            out, s);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What repro_bsr_launch chooses for these operands (``aligned``: K > 0, x,
// the blocks and the output 16-byte aligned; ``x_dtype`` x's code, 0 f32
// or 1 bf16), into out[8]: a tile's columns / 32, block-columns a chunk,
// units a block-row, groups, CTAs, units a group (warps a CTA), stages,
// and 1 for the tensor-core body (else 0).
extern "C" int repro_bsr_layout(int n_rb, int bm, int bk, int n, int batch,
                                int aligned, long long* out, int x_dtype) {
  const Layout l =
      choose_layout(n_rb, bm, bk, n, batch, aligned != 0, x_size(x_dtype));
  const long long vals[8] = {l.vec,    l.chunk, l.slabs, l.groups,
                             l.groups * l.tiles, kWarps, kStages, l.mma};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}
