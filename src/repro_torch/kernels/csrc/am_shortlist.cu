// am_shortlist: coarse pass of the hierarchical search. Each query is
// scored against the G packed super-centroids by XOR + popcount and the
// S best clusters are kept, ordered by (-sim, cluster id).
//
//   q        (B, Dp) uint8   packed queries, LSB-first along D, tail bits 0
//   super_t  (Dp, G) uint8   packed transposed super-centroids
//   scratch  (B, G)  uint64  key buffer, only when G keys do not fit in
//                            shared memory (else null)
//   idx      (B, S)  int32   cluster ids, best first, ties to the lower id
//   sim      (B, S)  float32 n_dims - 2 * popcount(q XOR super[:, idx])
//
// Replaces the TPU kernel src/repro/kernels/am_shortlist.py: am_shortlist
// (a (B/bB, G/128, Dp/16) Pallas grid of 8-bit SWAR popcounts whose
// epilogue merges each 128-column block into a per-query top-S scratch by
// S iterated max-then-min-id selections, carried across grid steps).
//
// Bound on the H100: operations. At the huge-label shape (B = 256,
// G = 448, D = 1024) the work is 2*B*G*D = 0.235 G int ops on operands
// exact in int8 (0.12 us at the int8 tensor-core rate) against ~0.1 MB of
// operands.
//
// Design (packed_topk.cuh): one block per query, nothing carried between
// blocks; the query's words sit in shared memory, each thread scores
// super-centroids j = tid, tid + 256, ... with 32-bit __popc words, and the
// keys (hamming << 32 | j) go through the exact rank selection, so the
// order needs no sort and no composite int32 key. Any 1 <= S <= G and any G
// (keys past packed_topk's shared-memory budget go to the scratch buffer).
#include "packed_topk.cuh"

namespace {

struct SuperSlots {
  const uint8_t* super_t;
  int G;
  __device__ int column(int, int p, const uint8_t** col,
                        size_t* stride) const {
    *col = super_t + p;
    *stride = (size_t)G;
    return p;
  }
};

}  // namespace

extern "C" int am_shortlist_launch(const void* q, const void* super_t,
                                   void* scratch, void* idx, void* sim,
                                   int B, int Dp, int G, int n_dims, int S,
                                   void* stream) {
  if (S < 1 || S > G) return (int)cudaErrorInvalidValue;
  const SuperSlots slots{static_cast<const uint8_t*>(super_t), G};
  return packed_topk::launch_topk(slots, q, B, Dp, G, S, n_dims, scratch,
                                  idx, sim, (cudaStream_t)stream);
}
