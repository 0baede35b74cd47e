// Monomial-weighted Grams of the SE(3) data term from K-sparse weight rows:
//   B[m] = (sqrt(s2) W)^T diag(mono_m(y)) (sqrt(s2) W)   (10 x D x D),
//   Bu   = W^T (s2 * delta),   Bw = W^T (s2 * (y x delta))   (D x 3 each),
// monomials [1, yx, yy, yz, yx^2, yx yy, yx yz, yy^2, yy yz, yz^2].
//
// Replaces monomial_grams_tpu (dynfu_tpu/solver/gram_pallas.py:184, body
// _mono_gram_kernel :135). The TPU kernel expands each 256-row tile into a
// dense (D, TQ) strip in VMEM and contracts it against its ten monomial-
// scaled copies on the MXU (3-pass bf16), carrying two (D, D) accumulators
// from one sequential grid step to the next: one order. Blocks here run in
// no order; an earlier version summed segments of rows in shared memory and
// flushed them with float32 atomics, so its last bits (and the fusion
// paths' accuracy figures) changed from run to run. It now sums in the
// fixed order of gram_gather.cuh, in float64, rounded once: a mark kernel
// sets per node the chunks of 32 rows that hold it, and one block per node
// sums row i of all ten Grams and both right-hand sides in row order.
//
// Bound: the bytes, ~30 MB at N = 2^17, K = 8, D = 640 (the (10, D, D)
// output written once, the rows read once), ~9 us at 3.35 TB/s; the block
// per node reads each of its rows once per pass of 32 neighbours and adds
// ten float64 products per cell of its 32 x 32 tiles.
#include "gram_gather.cuh"

DYNFU_API int dynfu_monomial_grams(const int* idx, const float* w,
                                   const float* s2, const float* y,
                                   const float* delta, int N, int K, int D,
                                   unsigned* scratch, float* B, float* Bu,
                                   float* Bw, void* stream) {
  return gg_launch<true>(idx, w, s2, y, delta, N, K, D, scratch, B, Bu, Bw,
                         (cudaStream_t)stream);
}

// The same sums before the final rounding: B, Bu and Bw in float64 (the
// partial Grams of a row range; dist/shard_gram.py adds the ranks' partials
// in rank order and rounds once).
DYNFU_API int dynfu_monomial_grams_f64(const int* idx, const float* w,
                                       const float* s2, const float* y,
                                       const float* delta, int N, int K,
                                       int D, unsigned* scratch, double* B,
                                       double* Bu, double* Bw, void* stream) {
  return gg_launch<true, double>(idx, w, s2, y, delta, N, K, D, scratch, B,
                                 Bu, Bw, (cudaStream_t)stream);
}
