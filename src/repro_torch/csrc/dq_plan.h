// Launch plan of the dynamic per-token quant (dynamic_quant.cu).
//
// This header is the one owner of how the kernel lays a row out: one warp
// per row, the row in registers as 16-byte vectors (8 bf16 or 4 f32 each),
// lane l holding vectors l, l + 32, l + 64, ... (`vecs` per lane, a
// template parameter of the kernel, rounded up to a power of two: the
// kernel masks each vector past the row's end, so `vecs` need only bound
// the row, and five instantiations cover every width), four rows (warps)
// per CTA; and of
// when a row takes the general path instead (a width that is not a whole
// number of vectors, a row start that is not 16-byte aligned, or more
// vectors per lane than the register path holds), which reads the row
// twice from global memory with scalar loads and so takes any width. It is
// plain C++ apart from the __host__ __device__ marks, so the kernel's C
// entry and a host C++ build (the CPU tests) compile the same rule; Python
// reads it through dq_plan, exported by the CUDA library.
#pragma once

#ifdef __CUDACC__
#define DQ_HD __host__ __device__
#else
#define DQ_HD
#endif

namespace dq {

constexpr int kVecBytes = 16;   // one vector load per lane
constexpr int kMaxVecs = 16;    // vectors per lane on the register path
                                // (64 registers of raw data)
constexpr int kMaxRows = 8;     // rows (warps) per CTA, forced
constexpr int kRows = 4;        // the plan's rows per CTA

struct Plan {
  int rows;   // rows (warps) per CTA
  int vecs;   // 16-byte vectors per lane (1, 2, 4, 8 or 16); 0: the
              // general path
  int ctas;   // CTAs of the grid
};

// The plan for m rows of d elements of `elt` bytes (4: f32, 2: bf16)
// whose first row starts at a 16-byte boundary when `aligned`; `rows`
// forces the rows per CTA (0: the plan's). Returns false for a shape the
// kernel does not take.
DQ_HD inline bool plan(int m, int d, int elt, int aligned, int rows,
                       Plan* p) {
  if (m < 1 || d < 1 || (elt != 2 && elt != 4) || rows < 0 ||
      rows > kMaxRows)
    return false;
  const int per = kVecBytes / elt;               // elements per vector
  const int need = (d / per + 31) / 32;         // vectors per lane
  int vecs = 1;
  while (vecs < need) vecs *= 2;
  p->vecs = (aligned && d % per == 0 && vecs <= kMaxVecs) ? vecs : 0;
  p->rows = rows ? rows : kRows;
  p->ctas = (m + p->rows - 1) / p->rows;
  return true;
}

}  // namespace dq

// out = {rows per CTA, vectors per lane (0: the general path), CTAs}.
// Returns 0, or 1 for a shape the kernel does not take.
extern "C" int dq_plan(int m, int d, int elt, int aligned, int rows,
                       int* out) {
  dq::Plan p;
  if (!dq::plan(m, d, elt, aligned, rows, &p)) return 1;
  out[0] = p.rows;
  out[1] = p.vecs;
  out[2] = p.ctas;
  return 0;
}
