// K1 fused product-stream replay for Hopper (sm_90a).
//
// Replaces: src/repro/core/pallas_stream.py, _fused_kernel (the Pallas TPU
// kernel launched by _fused_call).  It computes, for every output slot s,
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
// the offsets and the output, each once) over the card's memory rate.
//
// Design: the TPU kernel tiles the product axis into 128-product grid steps,
// reduces each step with a [128, 128] one-hot matmul and adds the partial
// sums into an output window.  That is safe only because TPU grid steps run
// in order, one after another.  CTAs on Hopper run concurrently, so here
// each output slot belongs to one thread: the thread walks its segment's
// products in stream order, acc = acc + x * y with __fmul_rn/__fadd_rn (so
// nvcc cannot contract them into an FMA), and writes out[s] once.  No
// atomics, no one-hot, no window: the result is bit-stable from run to run
// and equals the plain PyTorch version, which sums each slot in the same
// order.  Gathers are real indexed loads.  One thread per slot is
// latency-bound on long segments (a chain of dependent loads and adds);
// splitting long segments across a warp is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fused_stream_kernel(const int* __restrict__ idx_x,
                                    const int* __restrict__ idx_y,
                                    const int* __restrict__ seg_ptr,
                                    const float* __restrict__ x,
                                    const float* __restrict__ y, int n_out,
                                    float* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_out) return;
  const int hi = seg_ptr[s + 1];
  float acc = 0.0f;
  for (int q = seg_ptr[s]; q < hi; ++q) {
    acc = __fadd_rn(acc, __fmul_rn(x[idx_x[q]], y[idx_y[q]]));
  }
  out[s] = acc;
}

}  // namespace

extern "C" int repro_fused_stream_launch(const void* idx_x, const void* idx_y,
                                         const void* seg_ptr, const void* x,
                                         const void* y, int n_out, void* out,
                                         void* stream) {
  if (n_out > 0) {
    const int grid = (n_out + kThreads - 1) / kThreads;
    fused_stream_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx_x), static_cast<const int*>(idx_y),
        static_cast<const int*>(seg_ptr), static_cast<const float*>(x),
        static_cast<const float*>(y), n_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
