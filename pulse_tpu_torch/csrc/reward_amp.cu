// RA: the imitation env's reward/AMP epilogue on an already-stepped state,
// one thread per env (reward_amp.cuh, the same code K1 runs after its
// physics): reward, its 4 raw terms, mean/max termination distance and the
// AMP row.
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_reward_amp
// (body _build_reward_amp_kernel). Plain version:
// pulse_tpu_torch/env/cuda_obs.py:reward_amp_plain.
//
// Bound on the H100: by bytes. An env reads 785 floats (stepped bodies 13J,
// joint rotations and velocities 7(J-1), reference bodies 13J) and writes
// 239, with a few thousand float operations in between. Inputs and outputs
// are [rows, B], so a warp's 32 loads of one row are one 128-byte line; the
// stepped bodies sit in per-thread arrays.
#include <cuda_runtime.h>
#include <stddef.h>

#include "reward_amp.cuh"

using namespace hm;

// This translation unit's copy of the env constants (ra_set_consts).
static __constant__ EnvConsts c_env;

__global__ void __launch_bounds__(128) reward_amp_kernel(const float* __restrict__ in,
                                                         float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int J = c_env.J, Jm1 = J - 1;
  const RowsIn x{in + e, B};
  // input rows: bodies pos 3J | rot 4J | vel 3J | ang 3J | joint rot 4(J-1)
  // | joint omega 3(J-1) | reference bodies 13J
  const int bp = 0, br = 3 * J, bv = 7 * J, ba = 10 * J, r_jrot = 13 * J, r_om = r_jrot + 4 * Jm1;
  V3 pos[MAX_J], vel[MAX_J], ang[MAX_J];
  Q4 rot[MAX_J], jrot[MAX_J - 1];
  V3 omega[MAX_J - 1];
  for (int b = 0; b < J; ++b) {
    pos[b] = V3{x(bp + 3 * b), x(bp + 3 * b + 1), x(bp + 3 * b + 2)};
    rot[b] = Q4{x(br + 4 * b), x(br + 4 * b + 1), x(br + 4 * b + 2), x(br + 4 * b + 3)};
    vel[b] = V3{x(bv + 3 * b), x(bv + 3 * b + 1), x(bv + 3 * b + 2)};
    ang[b] = V3{x(ba + 3 * b), x(ba + 3 * b + 1), x(ba + 3 * b + 2)};
  }
  for (int j = 0; j < Jm1; ++j) {
    jrot[j] = Q4{x(r_jrot + 4 * j), x(r_jrot + 4 * j + 1), x(r_jrot + 4 * j + 2), x(r_jrot + 4 * j + 3)};
    omega[j] = V3{x(r_om + 3 * j), x(r_om + 3 * j + 1), x(r_om + 3 * j + 2)};
  }
  const RowsIn ref{in + e + (size_t)(r_om + 3 * Jm1) * B, B};
  reward_amp(c_env, pos, rot, vel, ang, jrot, omega, ref, RowsOut{out + e, B});
}

extern "C" {

size_t ra_env_consts_bytes() { return sizeof(EnvConsts); }

// Upload this unit's copy of the env table on `stream`.
int ra_set_consts(const void* env, size_t env_bytes, void* stream) {
  if (env_bytes != sizeof(EnvConsts)) return -1;
  cudaMemcpyToSymbolAsync(c_env, env, env_bytes, 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// in: [785, B] f32, out: [239, B] f32 at the SMPL humanoid's J = 24 (AMP v1).
int ra_reward_amp(const float* in, float* out, int B, int block, void* stream) {
  reward_amp_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(in, out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
