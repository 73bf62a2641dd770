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
// Types: the reference's contract.  blocks and x are each f32 or bf16 (four
// instances of one body, TW x TX), the sums are f32 and the output is in x's
// type.  A bf16 operand is widened with __bfloat162float (exact) where it is
// read, every product and sum is the f32 one below, in the same order, and
// a bf16 output is rounded once, by __float2bfloat16_rn, where it is stored:
// so the bf16 instances, too, equal the plain version bit for bit.  bf16
// operands stay bf16 in device memory and x in shared memory (a stage holds
// twice the rows); a piece of bf16 weights is widened on its way into
// shared memory, so the inner loop reads f32 weights in every instance.
//
// What bounds it on this card: operations.  Every kept block does
// 2 * bm * bk * N flops against bm * bk weights and bk * N activations read;
// at the sparse FFN's widths (K = 6144, N = 2048) that is hundreds of flops
// per byte of the operands, far above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte).  Each output element takes its products
// from 0.0f with nb ascending, then kk ascending, through __fmul_rn and
// __fadd_rn (no FMA contraction, no TF32, no atomics: one thread owns each
// output element), which is the plain PyTorch version's order, so the two
// agree bit for bit.  A multiply-add is then two instructions, so the floor
// of this order is twice the operation bound: 4.6 ms for granite-20b's gate
// at a prefill of 2048 tokens.  The bf16 instances run the same f32
// arithmetic, on SIMT units: the tensor cores (989 TFLOP/s in bf16) would
// need another order.
//
// The first design (one CTA per block-row x 128 columns, a thread a column)
// reached 41 % of that floor: each x value fetched through L1/L2 served only
// the 8 rows of one block (38.6 GB of x loads for that gate matmul), and
// about 22 instructions issued carried 16 multiplies and adds.
//
// Design: a CTA owns a group of kWarps units x one column tile, where a unit
// is 8 rows of one block-row (a slab; bm = 8 has one slab a block-row) and
// a warp owns one unit.  The CTA walks K in ascending chunks of whole
// block-columns, kStages chunks of x (chunk rows x tile columns) in flight
// in a ring of shared-memory stages; a stage's `full` mbarrier completes
// when its chunk has landed.  So an x value fetched once serves every
// block-row of the group that keeps its block-column: at keep 0.25 and
// kWarps = 16 almost every block-column of a chunk is used (1 - 0.75^16 =
// 99 %).  There is no producer warp: the last warp to finish reading a stage
// (a count in shared memory) stages the chunk kStages further on into it, so
// every warp has 128 registers and none waits for the others except for
// data.  Each warp keeps a cursor into its block-row's kept blocks and, for
// each chunk, walks those that fall inside it.  A lane holds an 8-row x
// kVec-column register tile; the block's weights reach shared memory as
// 8 x 8 pieces, transposed to [kk][row], so that for each kk a lane reads
// its kVec x values in kVec / 4 16-byte shared loads (bf16: one load of
// 2 kVec bytes, widened pairwise) and the piece's 8
// weights in two 16-byte broadcasts, then issues 8 * kVec multiplies and as
// many adds.  The next piece's weights and block index are loaded into
// registers while the current piece is summed (two floats a lane, a piece
// being 64 weights), and two pieces alternate in each warp's buffer, so one
// __syncwarp a piece suffices.
//
// Order: chunks ascend and each block-row's live block_idx is strictly
// ascending (bsr_from_dense's np.nonzero), so a block-row's walk over the
// chunks visits its blocks with nb ascending and each block's kk ascending:
// the products of every output element keep the plain version's order.  The
// wrapper states that precondition and trusts it, as it trusts the index
// bounds.  Padded blocks (nb >= block_nnz[i]) are never read; a block-row
// with no kept block writes zeros; every output element is stored once, so
// the wrapper allocates the output with torch.empty.
//
// Instances of one body.  The 8 x 8 blocks of the sparse FFN (a row of x
// a multiple of 16 bytes, so N a multiple of 4 in f32 and of 8 in bf16; x
// and out 16-byte aligned, K > 0) take a tile of 256 columns, 8 a
// lane, where N is a multiple of 256, else of 128 columns, 4 a lane.  They
// stage x with one TMA tensor copy a chunk (a 3-d map of x [B, K, N], its
// box the tile's columns x chunk rows of one element; rows past K and
// columns past N come as zeros), completing on `full` by bytes.  Every
// other block shape (1 <= bk <= 256, any bm, split into slabs of 8 rows and
// pieces of 8 kk, the last ones zero-padded in the rows and cut short in
// kk) takes 32 columns a CTA, one a lane, as many whole block-columns a
// chunk as fit a stage, and stages x by the electing warp's lanes
// (zero-filled past N): f32 with 4-byte cp.async gathers, bf16 with plain
// 2-byte loads and stores (cp.async copies 4, 8 or 16 bytes, and a row of
// bf16 x may start on 2 bytes), then an arrival that releases them.  A
// chunk holds kStageFloats * 4 bytes of x, so twice the rows in bf16.
// choose_layout makes this choice, and repro_bsr_layout reports it
// (kernels.bsr_layout) without a launch.
//
// Bytes: a CTA reads its group's kept blocks once and x's column tile once
// per group, through L2: for the gate matmul above (589,824 kept 8 x 8
// blocks, 151 MB; x 50.3 MB) that is 8 tiles x 151 MB = 1.2 GB of weights
// and 192 groups x 50.3 MB = 9.7 GB of x from L2 to the SMs.  The grid
// walks the groups of one column tile side by side, so the CTAs in flight
// share that tile of x (6.3 MB, which stays in L2) and each tile streams
// the weights once: about 8 x 151 MB of weights + 50.3 MB of x + 201 MB of
// output, 1.5 GB, cross the device-memory bus in one such launch, a
// quarter of a TB/s over its 6.4 ms.  Walking 4 or 8 tiles side by side, to
// read the weights from device memory once per 4 or 8 tiles, measured the
// same.
//
// On the H100 (700 W; benchmarks/torch_bsr_shapes.py) that gate matmul
// takes 6.4 ms, 72 % of the exact order's floor, and K5-b at the FFN's
// batch (x [8, 6144, 128]) 3.3 ms.  What holds it, by that script's
// ablations: the multiplies and adds themselves (one FMA a product: 3.9 ms,
// which the exact order forbids), then the shared-memory loads feeding them
// (without the weights' broadcasts 4.5 ms, without x's 4.8 ms); staging x
// costs nothing measurable, and a weight whose block-rows all keep the
// same blocks (no warp waits for another at a chunk) takes 6.1 ms.  Why
// one TMA copy a chunk and no producer warp: one bulk copy a row from a
// producer warp cost a third of the time (nvcc issues such copies lane by
// lane, in a loop), and a 17th warp caps the registers at 96.
//
// Batch: a batch element is a column tile of its own in the grid (the grid
// is one axis); element b reads x + b * K * N and writes
// out + b * n_rb * bm * N (int64 offsets), the weight is shared, and each
// element runs exactly the unbatched arithmetic, so batched equals looped
// bit for bit, and the unbatched launch is batch = 1.  At N = 128, folding
// two elements into one 256-column tile (8 columns a lane) took 3.245 ms
// against 3.260 for K5-b at gate on the H100 (700 W), 0.5 % less, and was
// left out.

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
__device__ __forceinline__ float widen_lo(unsigned pair) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(pair & 0xffffu)));
}
__device__ __forceinline__ float widen_hi(unsigned pair) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(pair >> 16)));
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

// two f32 sums as the bf16 pair [a, b] in one word, each rounded once
__device__ __forceinline__ unsigned narrow_pair(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
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

// 4 bytes, or zeros where `live` is false
__device__ __forceinline__ void gather4(void* dst, const void* src,
                                        bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// a lane's kVec consecutive x values of a staged row, as f32: f32 in
// 16-byte loads, bf16 in 16-byte (kVec 8) or 8-byte (kVec 4) loads
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
template <int kVec>
__device__ __forceinline__ void read_x(const __nv_bfloat16* xs,
                                       float (&xv)[kVec]) {
  unsigned pairs[kVec / 2];
  if constexpr (kVec == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xs);
    pairs[0] = u.x;
    pairs[1] = u.y;
    pairs[2] = u.z;
    pairs[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(xs);
    pairs[0] = u.x;
    pairs[1] = u.y;
  }
#pragma unroll
  for (int q = 0; q < kVec / 2; ++q) {
    xv[2 * q] = widen_lo(pairs[q]);
    xv[2 * q + 1] = widen_hi(pairs[q]);
  }
}

// a lane's kVec consecutive sums of one output row: f32 in 16-byte stores,
// bf16 rounded once each, in one 16-byte (kVec 8) or 8-byte (kVec 4) store
template <int kVec>
__device__ __forceinline__ void write_out(float* o, const float (&a)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    reinterpret_cast<float4*>(o)[q] =
        make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}
template <int kVec>
__device__ __forceinline__ void write_out(__nv_bfloat16* o,
                                          const float (&a)[kVec]) {
  if constexpr (kVec == 8) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(narrow_pair(a[0], a[1]), narrow_pair(a[2], a[3]),
                   narrow_pair(a[4], a[5]), narrow_pair(a[6], a[7]));
  } else {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(narrow_pair(a[0], a[1]), narrow_pair(a[2], a[3]));
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

  // the chunks the group's kept blocks fall in: from its least first block
  // to its greatest last block (block_idx ascends in every block-row)
  int lo = 0x7fffffff, hi = -1;
  if (lane < kWarps) {
    const int u = group * kWarps + lane;
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
  const int ch_lo = hi < 0 ? 0 : lo / kc;
  const int ch_hi = hi < 0 ? 0 : hi / kc + 1;

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
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&sm.done[s], 1) % kWarps == kWarps - 1;
      if (last) __threadfence_block();
    }
    if (__shfl_sync(0xffffffffu, last, 0) && c + kStages < ch_hi) {
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
  int vec;          // columns a lane: 8 or 4 (the 8 x 8 instances), 1
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
               sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
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
  if (w_dtype == 0 && x_dtype == 1) {
    return launch<kVec, float, __nv_bfloat16>(l, block_idx, block_nnz,
                                              blocks, n_rb, max_nb, bm, bk,
                                              x, k_dim, n, batch, out, s);
  }
  if (w_dtype == 1 && x_dtype == 0) {
    return launch<kVec, __nv_bfloat16, float>(l, block_idx, block_nnz,
                                              blocks, n_rb, max_nb, bm, bk,
                                              x, k_dim, n, batch, out, s);
  }
  if (w_dtype == 1 && x_dtype == 1) {
    return launch<kVec, __nv_bfloat16, __nv_bfloat16>(
        l, block_idx, block_nnz, blocks, n_rb, max_nb, bm, bk, x, k_dim, n,
        batch, out, s);
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
            reinterpret_cast<uintptr_t>(out) % 16 == 0,
        x_size(x_dtype));
    if (l.vec == 8) {
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

// What repro_bsr_launch chooses for these operands (``aligned``: K > 0, x
// and the output 16-byte aligned; ``x_dtype`` x's code, 0 f32 or 1 bf16),
// into out[7]: columns a lane, block-columns a chunk, units a block-row,
// groups, CTAs, units a group (warps a CTA), stages.
extern "C" int repro_bsr_layout(int n_rb, int bm, int bk, int n, int batch,
                                int aligned, long long* out, int x_dtype) {
  const Layout l =
      choose_layout(n_rb, bm, bk, n, batch, aligned != 0, x_size(x_dtype));
  const long long vals[7] = {l.vec,    l.chunk, l.slabs, l.groups,
                             l.groups * l.tiles, kWarps, kStages};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
