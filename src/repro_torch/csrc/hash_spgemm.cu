// K4 HASH SpGEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hash_spgemm.py, _hash_kernel (the Pallas TPU
// kernel behind hash_spgemm) and its vmapped form hash_spgemm_batched: the
// SPARS lock-step skeleton with a linear-probed hash table of h slots per
// lane (Section 3.2).  Same operands as K3; outputs keys (int32, -1 = empty)
// and vals (f32), both [h, n_b] row-major, slot for slot as the reference
// lays them out, or [B, h, n_b] for B value sets of one pattern.
//
// What bounds it on this card: bytes.  A step is one multiply and one add, a
// few probes of the lane's table and three dependent gathers; the least time
// is the bytes the group must move (B entries, the A columns they reference,
// and the two [h, n_b] tables, written once) over the card's memory rate.
//
// Design: one thread owns one lane and its private table, so nothing is
// shared and nothing is atomic.  Each thread runs steps[lane / block_cols]
// iterations of the reference's cursor state machine.  The slot of row r
// starts at ((uint32)r * 0x1E3779B1u) & (h - 1), which equals the reference's
// int32 (r * (HASH_C & 0x7FFFFFFF)) % h and the host's (r * HASH_C) % H for a
// power of two h (the arithmetic is unsigned, because signed overflow is
// undefined in C++).  The probe walks at most h slots for the first whose key
// is r or -1; when none is found it falls back to slot 0, as the reference's
// pos_final = 0 does (the plan's table sizes never let that happen).  Then
// vals[slot] += product (__fmul_rn/__fadd_rn: no FMA) and keys[slot] = r.  A B
// entry that names an empty A column still takes one step, as in the
// reference: it inserts key a_rows[k, 0] = 0 with the product ±0.  Threads of
// a warp are neighbouring lanes, so a probe of one slot by a warp reads one
// segment.  The tables live in the output arrays in device memory (the
// wrapper fills keys with -1 and vals with 0); tables in shared memory are
// later work.
//
// Batch: blockIdx.y is the batch element (vmap's leading grid axis on the
// TPU).  Element b reads a_vals + b*n_a*za and b_vals + b*n_b*zb and writes
// keys and vals + b*h*n_b (int64 offsets).  Probing depends on rows alone,
// so every element writes the same keys, as the reference returns them, and
// its slice equals the unbatched kernel bit for bit (the unbatched launch is
// batch = 1).  A group is one CTA, so the batch axis puts B CTAs in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kHashC = 0x1E3779B1u;  // HASH_C & 0x7FFFFFFF

__global__ void hash_kernel(const int* __restrict__ a_rows,
                            const float* __restrict__ a_vals,
                            const int* __restrict__ a_nnz, int n_a, int za,
                            const int* __restrict__ b_rows,
                            const float* __restrict__ b_vals,
                            const int* __restrict__ b_nnz, int n_b, int zb,
                            const int* __restrict__ steps, int block_cols,
                            int h, int* __restrict__ keys,
                            float* __restrict__ vals) {
  const int64_t elem = blockIdx.y;
  a_vals += elem * n_a * za;
  b_vals += elem * n_b * zb;
  keys += elem * h * n_b;
  vals += elem * h * n_b;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_b) return;
  const int n_steps = steps[lane / block_cols];
  const int nb = b_nnz[lane];
  const unsigned mask = static_cast<unsigned>(h - 1);
  const int64_t b_base = static_cast<int64_t>(lane) * zb;
  int vidx_b = 0;
  int vcnt_a = 0;
  for (int s = 0; s < n_steps && vidx_b < nb; ++s) {
    const int k = b_rows[b_base + vidx_b];
    const float bv = b_vals[b_base + vidx_b];
    const int na = a_nnz[k];
    const int64_t a_at = static_cast<int64_t>(k) * za + vcnt_a;
    const int r = a_rows[a_at];
    const float contrib = __fmul_rn(a_vals[a_at], bv);
    unsigned pos = (static_cast<unsigned>(r) * kHashC) & mask;
    unsigned slot = 0;  // the reference's pos_final when no slot is found
    for (int p = 0; p < h; ++p) {
      const int key = keys[static_cast<int64_t>(pos) * n_b + lane];
      if (key == r || key == -1) {
        slot = pos;
        break;
      }
      pos = (pos + 1) & mask;
    }
    const int64_t cell = static_cast<int64_t>(slot) * n_b + lane;
    vals[cell] = __fadd_rn(vals[cell], contrib);
    keys[cell] = r;
    if (vcnt_a + 1 >= na) {
      vcnt_a = 0;
      ++vidx_b;
    } else {
      ++vcnt_a;
    }
  }
}

}  // namespace

extern "C" int repro_hash_launch(const void* a_rows, const void* a_vals,
                                 const void* a_nnz, int n_a, int za,
                                 const void* b_rows, const void* b_vals,
                                 const void* b_nnz, int n_b, int zb,
                                 const void* steps, int block_cols, int h,
                                 int batch, void* keys, void* vals,
                                 void* stream) {
  if (n_b > 0 && batch > 0) {
    const dim3 grid((n_b + kThreads - 1) / kThreads, batch);
    hash_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_nnz), n_a, za,
        static_cast<const int*>(b_rows), static_cast<const float*>(b_vals),
        static_cast<const int*>(b_nnz), n_b, zb,
        static_cast<const int*>(steps), block_cols, h,
        static_cast<int*>(keys), static_cast<float*>(vals));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
