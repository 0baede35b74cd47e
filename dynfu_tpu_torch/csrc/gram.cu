// GN data-term normal equations from K-sparse weight rows:
//   A = W^T diag(s2) W  (D x D),   b = W^T (s2 * delta)  (D x 3).
//
// Replaces data_normal_tpu (dynfu_tpu/solver/gram_pallas.py:85, body
// _gram_kernel :56). The TPU kernel expands each 256-row tile into dense
// (D, TQ) strips in VMEM and contracts them on the MXU, carrying A in VMEM
// from one sequential grid step to the next: every entry of A sums its
// terms in one order. Here blocks run in no order, so the sums follow the
// fixed order of gram_gather.cuh (float64, one rounding, the same bits on
// every launch) in two launches: a mark kernel sets per node the chunks of
// 32 rows that hold it, and one block per node (gg_row_kernel) sums row i
// of A and b in row order into a float64 row of D per warp. A float32-atomic
// version gave other last bits on every launch (the 41 GN solves of a
// parity run turned those into +-0.8 mm of err_after_3x_motion_mm); a
// counting sort that fixed the order took three more launches and two
// (chunks x D) int tables; per-chunk records of the pair sums, 14 MB of
// scratch at parity 512^3's call, took 0.34 ms on the H100 at chip_smoke.py's
// kernel-phase rows (uniformly random nodes).
#include "gram_gather.cuh"

// 32-bit words of scratch the Gram kernels need (both Grams)
DYNFU_API long long dynfu_gram_scratch(int N, int D) {
  return gg_scratch_words(N, D);
}

// the warps per block for N rows and D nodes (the shares of each node's
// rows); mono selects the monomial Grams' launch
DYNFU_API int dynfu_gram_warps(int N, int D, int mono, int* warps) {
  *warps = mono ? gg_warps(D, gg_words(N)) : gg_row_warps(D, gg_words(N));
  return *warps ? 0 : (int)cudaErrorInvalidValue;
}

DYNFU_API int dynfu_data_normal(const int* idx, const float* w,
                                const float* s2, const float* delta, int N,
                                int K, int D, unsigned* scratch, float* A,
                                float* b, void* stream) {
  return gg_launch<false, float>(idx, w, s2, nullptr, delta, N, K, D,
                                 scratch, A, b, nullptr,
                                 (cudaStream_t)stream);
}

// The same sums before the final rounding: A and b in float64 (the partial
// Gram of a row range; dist/shard_gram.py adds the ranks' partials in rank
// order and rounds once).
DYNFU_API int dynfu_data_normal_f64(const int* idx, const float* w,
                                    const float* s2, const float* delta,
                                    int N, int K, int D, unsigned* scratch,
                                    double* A, double* b, void* stream) {
  return gg_launch<false, double>(idx, w, s2, nullptr, delta, N, K, D,
                                  scratch, A, b, nullptr,
                                  (cudaStream_t)stream);
}
