// Quantized contractions from precomputed activation codes for Hopper
// (sm_90a), plain C interface:
//   out[m, n] = sx[m] * sw[n] * (sum_k qx[m, k] qw[k, n] - zx[m] colsum[n])
// for int8 activation codes qx (m, k) against nibble-packed int4 weight
// codes (ceil(k/2), n) (quant_gemv_w4, quant_matmul_w4) or int8 codes
// (k, n) (quant_matmul), f32 out.
//
// Replaces the Pallas TPU kernels quant_matmul_w4 and quant_gemv_w4 of
// src/repro/kernels/quant_matmul_w4.py:72 and :127 and quant_matmul of
// src/repro/kernels/quant_matmul.py:42. The Pallas kernels add one f32
// epilogue per K tile; these accumulate exact int32 over all of K and
// apply the epilogue once, as the reference's oracle does. Odd K: the
// packed weight's last byte carries a zero high nibble and the missing
// activation code reads as 0, as the reference pads qx.
//
// All three run the contractions of contract.cuh that the fused CAT
// linear's stage 2 runs: the GEMV (quant_gemv_w4; quant_matmul for m <=
// 8) and the tensor-core one (quant_matmul_w4 at any m, quant_matmul
// above 8 rows: mma.sync m16n8k32 s8 on 64 x 64 tiles, weights
// transposed in shared memory, nibbles unpacked to s8 there for the
// packed weight, K split across CTAs where the tiles alone leave SMs
// idle).
//
// Bound on this card: the weight codes (k/2 x n packed, k x n int8) over
// HBM bandwidth at decode shapes and at 128 rows alike; the int8
// operations (2 m k n) are far below the tensor-core rate.
#include "contract.cuh"

namespace {

// The packed weight's unpacked row count for k activation codes.
int k_pad_w4(int k) { return 2 * ((k + 1) / 2); }

}  // namespace

// qx (m, k) int8, sx/zx (m,) f32, qw packed (ceil(k/2), n) int8, sw (n,)
// f32 -> out (m, n) f32; m <= 8. Returns cudaGetLastError().
extern "C" int quant_gemv_w4(const void* qx, int m, int k, const void* sx,
                             const void* zx, const void* qw, const void* sw,
                             int n, void* out, void* stream_ptr) {
  return (int)contract::launch_gemv(qx, k, k, sx, zx, m, k_pad_w4(k), qw,
                                    1, sw, n, out,
                                    static_cast<cudaStream_t>(stream_ptr));
}

// As quant_gemv_w4, any m, through the tensor-core contraction with
// ``splits`` K splits and their scratch ws (quant_matmul_plan of (m, k,
// n)). Returns cudaGetLastError().
extern "C" int quant_matmul_w4(const void* qx, int m, int k, const void* sx,
                               const void* zx, const void* qw, const void* sw,
                               int n, int splits, void* ws, void* out,
                               void* stream_ptr) {
  return (int)contract::launch_mma(qx, k, k, sx, zx, m, k_pad_w4(k), qw, 1,
                                   sw, n, splits, ws, out,
                                   static_cast<cudaStream_t>(stream_ptr));
}

// K splits of quant_matmul's or quant_matmul_w4's (m, k) x (k, n)
// contraction (and of the fused linear's stage 2, k = k_pad) on a card of
// ``sms`` SMs (contract::w8a8_splits; 1 for m <= 8); *scratch gets the
// zeroed int32 elements they need (0 for one split).
extern "C" int quant_matmul_plan(int m, int k, int n, int sms,
                                 long long* scratch) {
  const int splits = contract::w8a8_splits(m, k, n, sms);
  *scratch = contract::w8a8_scratch(m, n, splits);
  return splits;
}

// qx (m, k) int8 against int8 weight codes qw (k, n): the GEMV for m <= 8,
// the tensor-core contraction above with ``splits`` K splits and their
// scratch ws, as quant_matmul_plan gives them. Returns cudaGetLastError().
extern "C" int quant_matmul(const void* qx, int m, int k, const void* sx,
                            const void* zx, const void* qw, const void* sw,
                            int n, int splits, void* ws, void* out,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m <= contract::kGemvM)
    return (int)contract::launch_gemv(qx, k, k, sx, zx, m, k, qw, 0, sw, n,
                                      out, stream);
  return (int)contract::launch_mma(qx, k, k, sx, zx, m, k, qw, 0, sw, n,
                                   splits, ws, out, stream);
}
