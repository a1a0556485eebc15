// Native batch packer of fabind_tpu_torch.
//
// The port's own copy of the JAX package's packer (native/collate.cc), with
// the same C ABI. It packs ragged per-sample arrays into fixed-shape padded
// batch buffers, the host-side loop of the input pipeline (the python
// collator is fabind_tpu_torch/data/batching.py::collate). It is bound with
// ctypes by fabind_tpu_torch/data/native.py. All buffers are
// caller-allocated numpy arrays; this code only copies and scatters. It is
// host code: no device work.
//
// Build: $CXX -O3 -shared -fPIC -o libfabind_collate.so collate.cc
// (driven by fabind_tpu_torch/data/native.py::build_library, into
// build/native/)

#include <cstdint>
#include <cstring>

extern "C" {

// Copy a ragged [n, d] float32 array into row b of a padded [B, N, d] buffer
// and set the first n entries of the bool mask row. Returns 0, or -1 when
// n would overrun the slot — the caller-side (python) shape checks are
// authoritative, but a defensive check here means a binding bug corrupts
// nothing (memcpy past the slot would silently trash later batch rows or
// the heap).
int32_t pack_f32(const float* src, int64_t n, int64_t d,
                 float* dst, uint8_t* mask, int64_t b, int64_t N) {
  if (n < 0 || n > N || d <= 0) return -1;
  std::memcpy(dst + (b * N) * d, src, sizeof(float) * n * d);
  if (mask) {
    std::memset(mask + b * N, 1, n);
  }
  return 0;
}

// Build the bond neighbor table for one sample from a directed edge list
// [e, 2]: bond_idx[b, i, k] = j for the k-th neighbor of i; dedupes repeated
// edges; returns the max degree (so callers can detect bucket overflow).
int64_t pack_bonds(const int64_t* edges, int64_t e,
                   int32_t* bond_idx, uint8_t* bond_mask,
                   int64_t b, int64_t N, int64_t K) {
  int64_t max_deg = 0;
  // degree counter per destination (stack-allocated cap: N <= 4096)
  int32_t deg[4096];
  if (N > 4096) return -1;
  std::memset(deg, 0, sizeof(int32_t) * N);
  for (int64_t t = 0; t < e; ++t) {
    int64_t i = edges[2 * t];
    int64_t j = edges[2 * t + 1];
    if (i < 0 || i >= N || j < 0 || j >= N) return -2;
    // dedupe against the STORED neighbors only (first K): deg[i] counts true
    // degree and may exceed K, but row holds just K entries — scanning past
    // K would read the next atom's row (OOB). A duplicate edge arriving
    // after K unique neighbors is counted again, which can only over-report
    // max_deg -> callers raise a conservative overflow error, never ship a
    // silently corrupted table.
    bool dup = false;
    int32_t* row = bond_idx + (b * N + i) * K;
    int32_t scan = deg[i] < (int32_t)K ? deg[i] : (int32_t)K;
    for (int32_t k = 0; k < scan; ++k) {
      if (row[k] == (int32_t)j) { dup = true; break; }
    }
    if (dup) continue;
    if (deg[i] < K) {
      row[deg[i]] = (int32_t)j;
      bond_mask[(b * N + i) * K + deg[i]] = 1;
    }
    deg[i]++;
    if (deg[i] > max_deg) max_deg = deg[i];
  }
  return max_deg;
}

// Pack a ragged [n, n] bool LAS adjacency into row b of [B, N, N].
// Returns 0, or -1 when n exceeds the slot.
int32_t pack_adj(const uint8_t* src, int64_t n, uint8_t* dst, int64_t b,
                 int64_t N) {
  if (n < 0 || n > N) return -1;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + (b * N + i) * N, src + i * n, n);
  }
  return 0;
}

}  // extern "C"
