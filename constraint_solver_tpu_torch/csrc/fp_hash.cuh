// The fingerprint hash of one (position, value) pair, shared by every kernel
// that writes fingerprints (fingerprint.cu: K2; sched_dense.cu: K5), so their
// outputs agree bit for bit.  For a position i and a value v, in uint32 and
// for each of the JAX package's two lane salts (constraint_solver_tpu/ops/fingerprint.py),
//
//   h(i, v) = mix32(v ^ mix32(i ^ salt)),   mix32 = murmur3's fmix32 finalizer
//
// Inputs are taken modulo 2^32, as the JAX package's astype(uint32) does.

#pragma once

#include <cstdint>

namespace fp_hash {

constexpr uint32_t kSalt0 = 0x9E3779B9u;  // the JAX package's two lane salts
constexpr uint32_t kSalt1 = 0x85EBCA77u;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// h(pos, v) for the lane salted by `salt`.
__device__ __forceinline__ uint32_t hash(uint32_t pos, uint32_t v, uint32_t salt) {
  return mix32(v ^ mix32(pos ^ salt));
}

}  // namespace fp_hash
