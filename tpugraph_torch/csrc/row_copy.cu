// One row of x copied to out: out[0] = x[idx[0]] (row_copy_forward).
//
// Replaces scripts/fused_gcn_probe.py:41 tiny_kernel, stage 0 of the fused
// GCN layer's probe: one row fetched by one DMA into VMEM, the platform's
// check that a gather by an index read inside the kernel works at all
// (kernels/probe.py, scripts/fused_gcn_probe_torch.py).
//
// What bounds it: one row of a few hundred bytes read and written, well
// under a microsecond at 3.35 TB/s; what a launch pays is its own latency.
// So the design is one block that reads the index and copies the row in
// 4-byte words (a row of any element type is a whole number of them when
// its bytes are; else bytes).  An index outside [0, n) traps: the launch
// fails instead of reading outside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__global__ void row_copy_kernel(const W* __restrict__ x, const int* __restrict__ idx,
                                W* __restrict__ out, int n, long words) {
  const int src = __ldg(idx);
  if (src < 0 || src >= n) __trap();
  for (long i = threadIdx.x; i < words; i += blockDim.x) out[i] = __ldg(x + src * words + i);
}

}  // namespace

// x (n, row_bytes / element) of any element type, idx one int32 on the
// device, out one row; row_bytes the bytes of a row.  One launch on
// `stream`; returns its cudaError_t.
extern "C" int row_copy_forward(const void* x, const int* idx, void* out, int n, long row_bytes,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || row_bytes < 1) return cudaErrorInvalidValue;
  if (row_bytes % 4 == 0)
    row_copy_kernel<uint32_t><<<1, 128, 0, s>>>(static_cast<const uint32_t*>(x), idx,
                                                 static_cast<uint32_t*>(out), n, row_bytes / 4);
  else
    row_copy_kernel<uint8_t><<<1, 128, 0, s>>>(static_cast<const uint8_t*>(x), idx,
                                                static_cast<uint8_t*>(out), n, row_bytes);
  return cudaGetLastError();
}
