// K1 fused product-stream replay for Hopper (sm_90a).
//
// Replaces: src/repro/core/pallas_stream.py, _fused_kernel (the Pallas TPU
// kernel launched by _fused_call) and its vmapped form fused_fn_batched.  It
// computes, for every output slot s,
//
//   out[s] = sum over q in [seg_ptr[s], seg_ptr[s+1]) of x[idx_x[q]] * y[idx_y[q]]
//
// over a stream whose segments are consecutive.  One kernel serves three
// replays of a plan's product stream: the forward pass (x, y = the A and B
// values, segments = C slots) and the two gradient passes (x = the output
// cotangent through the C-slot ids, y = the other operand's values,
// segments = the differentiated operand's value positions).
//
// What bounds it on this card: bytes.  Each product is one multiply and one
// add against two 4-byte indices and two 4-byte gathered values; the least
// time is the bytes the replay must move (the indices, the gathered values,
// the offsets and the output, each once) over the card's memory rate.  A
// second floor comes from the order: each slot sums its products one after
// another from 0.0f, so the longest slot takes at least its length times
// the latency of one dependent add (about 4 cycles): 3000 products, about
// 6-7 us, at the largest view the port replays.
//
// Order: every slot's sum is acc = acc + x * y over its products in stream
// order, from 0.0f, with __fmul_rn/__fadd_rn (so nvcc cannot contract them
// into an FMA).  That is the plain PyTorch version's order, so the two agree
// bit for bit, and the result is the same from run to run: one owner per
// slot, no atomics.  The TPU kernel's one-hot [128, 128] matmul and its
// output window carried across sequential grid steps are TPU idioms; CTAs
// here run concurrently, so nothing is carried between them.
//
// Design: two tiers in one launch.
// - Short slots (at most kLongSlot products): one thread a slot walks its
//   products (the loop unrolled kShortUnroll times, so the loads of several
//   products are in flight: they do not depend on the adds).
// - Long slots (more than kLongSlot): one warp a slot, from a list of their
//   ids that the host builds with the view (long_slots).  A short-tier
//   thread that finds its slot long writes nothing: the slot's warp owns
//   it.  The warp walks its slot in rounds of 32 consecutive products: lane
//   k loads idx_x[q0 + k] and idx_y[q0 + k] (coalesced), gathers x and y and
//   multiplies.  kDepth rounds are gathered together, and the next kDepth
//   rounds' indices are loaded before the current rounds are summed, so the
//   loads are off the chain.  The products go to the warp's slice of shared
//   memory, every lane reads them back four at a time (16-byte broadcasts)
//   and adds them in lane order, acc = acc + p[k] for k = 0 .. 31, round
//   after round, which is the stream order; lane 0 writes the slot.
//   (Broadcasting each product by __shfl_sync instead, one warp instruction
//   a product on the SM's one shuffle unit, took 0.073 / 0.055 ms on the
//   largest gradient views against 0.052 / 0.045 staged, on an H100 SXM
//   at 700 W.)  Lanes past the
//   slot's end contribute +0.0f, which leaves the sum unchanged bit for
//   bit: acc starts at +0.0f and RN(a + b) is -0.0f only when a and b are
//   both -0.0f, so acc is never -0.0f, and acc + (+0.0f) == acc for every
//   other acc.
// The warp CTAs come first in the grid (the lowest blockIdx.x), so the long
// chains start when the launch starts, not in its tail.  Before this
// design every slot had one thread, and a launch waited on its longest
// slot's chain of dependent loads: about 96 ns a product.  Slots of 33-76
// products (the medium gradient slots of Goodwin_013 and ex22) ran faster
// on threads than on warps, hence kLongSlot = 64.
//
// Batch: a short-tier thread carries a tile of up to kBatchTile value sets
// (blockIdx.y is the tile), sharing one read of seg_ptr and both index
// vectors; it gathers, keeps one accumulator and writes once per element.
// A long slot gets a warp for each value set of the tile, which reads its
// indices again (long slots hold a small share of a forward view's
// products: 3000 of 9.0M at iprob); a warp that carried all 8 chains
// became the launch's tail (0.244 against 0.217 ms for iprob's forward
// view at B = 8, the same call).  Element b reads x + b*n_x and y + b*n_y
// and writes out + b*n_out (int64 offsets).  Each element's sum is the same
// sequence of __fmul_rn/__fadd_rn whatever its place in a tile, so a
// batched launch's slice b equals the unbatched kernel (the same body with
// a tile of 1) on value set b bit for bit.
//
// Registers: the unbatched instance is held to 32 registers, so that the
// short tier, which carries the forward view of a product stream (millions
// of one-product slots), runs at the SM's full 2048 threads; the batched
// instance to 64 (kBatchedSmThreads; at about 80 it ran slower).  The two
// tiers share one register budget, so the warp tier's depth sets how many
// of the short tier's loads stay in flight: at kDepth 4 the unbatched
// instance's short tier ran up to 22 % slower on views with no long slot
// (Goodwin_013's grad_b: 0.0206 against 0.0174 ms at kDepth 3, spilling
// nothing in either), while the long slots gain nothing from a fourth
// round (benchmarks/torch_fused_shapes.py, H100 SXM at 700 W).
//
// Every slot is written exactly once, by one tier, so the wrapper allocates
// the output with torch.empty; long_slots must list exactly the slots
// longer than kLongSlot (kernels/fused_stream.py keeps the constant's Python
// copy, LONG_SLOT), as the indices must lie in bounds: the card checks
// neither.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads a CTA, in either tier
constexpr int kLongSlot = 64;     // a slot with more products gets a warp
constexpr int kDepth = 3;         // rounds of 32 products a warp gathers together
constexpr int kBatchTile = 8;     // value sets a short-tier thread carries
constexpr int kShortUnroll = 4;   // products a short-tier thread unrolls
// threads an SM holds, which caps the registers: the unbatched instance
// at kSmThreads (the SM's 2048), the batched one at kBatchedSmThreads
constexpr int kSmThreads = 2048;
constexpr int kBatchedSmThreads = 1024;
constexpr int kWarps = kThreads / 32;

// A tile of value sets puts kTile gathers of each product in flight, so the
// batched instance's short tier unrolls kShortUnroll / kTile products, at
// least 1.
template <int kTile>
constexpr int kUnrollOf = kTile >= kShortUnroll ? 1 : kShortUnroll / kTile;

struct Args {
  const int* idx_x;
  const int* idx_y;
  const int* seg_ptr;
  const int* long_slots;
  const float* x;
  const float* y;
  float* out;
  int n_x, n_y, n_out, n_long, batch;
};

__device__ __forceinline__ float gather(const float* __restrict__ v, int i) {
  return __ldg(v + i);
}

// One short slot for the tile's nb value sets (x, y and out already at the
// tile's first element).
template <int kTile>
__device__ __forceinline__ void short_slot(const Args& a, const float* x,
                                           const float* y, float* out, int s,
                                           int nb) {
  const int lo = a.seg_ptr[s];
  const int hi = a.seg_ptr[s + 1];
  if (hi - lo > kLongSlot) return;  // the slot's warp writes it
  float acc[kTile];
#pragma unroll
  for (int b = 0; b < kTile; ++b) acc[b] = 0.0f;
#pragma unroll(kUnrollOf<kTile>)
  for (int q = lo; q < hi; ++q) {
    const int ix = a.idx_x[q];
    const int iy = a.idx_y[q];
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      if (b < nb) {
        acc[b] = __fadd_rn(acc[b],
                           __fmul_rn(gather(x + int64_t(b) * a.n_x, ix),
                                     gather(y + int64_t(b) * a.n_y, iy)));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kTile; ++b) {
    if (b < nb) out[int64_t(b) * a.n_out + s] = acc[b];
  }
}

// acc + v.x + v.y + v.z + v.w, one add after another
__device__ __forceinline__ float add4(float acc, float4 v) {
  acc = __fadd_rn(acc, v.x);
  acc = __fadd_rn(acc, v.y);
  acc = __fadd_rn(acc, v.z);
  return __fadd_rn(acc, v.w);
}

// One long slot s of one value set (x, y and out at that set), by the whole
// warp; stage holds the warp's kDepth * 32 floats.
__device__ __forceinline__ void long_slot(const Args& a, const float* x,
                                          const float* y, float* out, int s,
                                          int lane, float* stage) {
  const int lo = a.seg_ptr[s];
  const int hi = a.seg_ptr[s + 1];
  int ix[kDepth], iy[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int q = lo + 32 * d + lane;
    ix[d] = q < hi ? a.idx_x[q] : 0;
    iy[d] = q < hi ? a.idx_y[q] : 0;
  }
  float acc = 0.0f;
  for (int q0 = lo; q0 < hi; q0 += 32 * kDepth) {
    // this batch of rounds: lane k's product of each round
    float p[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      p[d] = q0 + 32 * d + lane < hi
                 ? __fmul_rn(gather(x, ix[d]), gather(y, iy[d]))
                 : 0.0f;
    }
    // the next batch's indices, loaded while this batch is summed
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int q = q0 + 32 * (kDepth + d) + lane;
      ix[d] = q < hi ? a.idx_x[q] : 0;
      iy[d] = q < hi ? a.idx_y[q] : 0;
    }
    // the chain: the rounds' products staged in the warp's shared memory,
    // then read back four at a time (16-byte broadcasts) by every lane and
    // added in lane order
#pragma unroll
    for (int d = 0; d < kDepth; ++d) stage[d * 32 + lane] = p[d];
    __syncwarp();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (q0 + 32 * d >= hi) break;  // uniform across the warp
#pragma unroll
      for (int k4 = 0; k4 < 8; ++k4) {
        const float4 v = reinterpret_cast<const float4*>(stage)[d * 8 + k4];
        acc = add4(acc, v);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
  }
  if (lane == 0) out[s] = acc;
}

// blockIdx.x < warp_ctas: kWarps warps a CTA, a warp for each long slot and
// value set of the tile; past them, kThreads slots a CTA, a thread each
// (all the tile's value sets).  blockIdx.y: the tile of value sets.
template <int kTile>
__global__ void __launch_bounds__(
    kThreads, (kTile == 1 ? kSmThreads : kBatchedSmThreads) / kThreads)
    fused_stream_kernel(const Args a, int warp_ctas) {
  // the unbatched instance's one value set, known to the compiler: a
  // predicate on every gather measured up to 1.6x slower on its short tier,
  // and its grid has one row, so x, y and out are the arguments themselves
  // and hold no registers
  const int b0 = kTile == 1 ? 0 : blockIdx.y * kTile;
  const int nb = kTile == 1 ? 1 : min(kTile, a.batch - b0);
  const float* x = a.x + int64_t(b0) * a.n_x;
  const float* y = a.y + int64_t(b0) * a.n_y;
  float* out = a.out + int64_t(b0) * a.n_out;
  if (static_cast<int>(blockIdx.x) < warp_ctas) {
    __shared__ __align__(16) float stage[kWarps * kDepth * 32];
    const int warp = threadIdx.x / 32;
    const int w = blockIdx.x * kWarps + warp;
    const int i = w / kTile;
    const int b = w % kTile;
    if (i < a.n_long && b < nb) {
      long_slot(a, x + int64_t(b) * a.n_x, y + int64_t(b) * a.n_y,
                out + int64_t(b) * a.n_out, a.long_slots[i], threadIdx.x % 32,
                stage + warp * kDepth * 32);
    }
    return;
  }
  const int s = (blockIdx.x - warp_ctas) * kThreads + threadIdx.x;
  if (s < a.n_out) short_slot<kTile>(a, x, y, out, s, nb);
}

}  // namespace

extern "C" int repro_fused_stream_launch(const void* idx_x, const void* idx_y,
                                         const void* seg_ptr,
                                         const void* long_slots, int n_long,
                                         const void* x, const void* y, int n_x,
                                         int n_y, int n_out, int batch,
                                         void* out, void* stream) {
  if (n_out > 0 && batch > 0) {
    const Args a{static_cast<const int*>(idx_x),
                 static_cast<const int*>(idx_y),
                 static_cast<const int*>(seg_ptr),
                 static_cast<const int*>(long_slots),
                 static_cast<const float*>(x),
                 static_cast<const float*>(y),
                 static_cast<float*>(out),
                 n_x, n_y, n_out, n_long, batch};
    const int tile = batch == 1 ? 1 : kBatchTile;
    const int warp_ctas =
        static_cast<int>((int64_t(n_long) * tile + kWarps - 1) / kWarps);
    const int short_ctas = (n_out + kThreads - 1) / kThreads;
    const auto s = static_cast<cudaStream_t>(stream);
    if (batch == 1) {
      fused_stream_kernel<1><<<dim3(warp_ctas + short_ctas, 1), kThreads, 0,
                               s>>>(a, warp_ctas);
    } else {
      const int tiles = (batch + tile - 1) / tile;
      fused_stream_kernel<kBatchTile>
          <<<dim3(warp_ctas + short_ctas, tiles), kThreads, 0, s>>>(
              a, warp_ctas);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
