// RA: the imitation env's reward/AMP epilogue on an already-stepped state
// (reward_amp.cuh, the same code K1 runs after its physics): reward, its 4
// raw terms, mean/max termination distance and the AMP row.
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_reward_amp
// (body _build_reward_amp_kernel). Plain version:
// pulse_tpu_torch/env/cuda_obs.py:reward_amp_plain.
//
// Bound on the H100: by bytes. An env reads 785 floats (stepped bodies 13J,
// joint rotations and velocities 7(J-1), reference bodies 13J) and writes
// 239, with ~5,000 float operations in between. The design keeps loads in
// flight: one warp an env, 8 envs a block (384 blocks at 3072 envs, all
// resident at once). The warp copies the env's ten input blocks into shared
// memory (RaEnv, 3.6 KB), reading the [B, ...] tensors in place through a
// pointer and an env stride each, 32 consecutive floats a load; then its
// lanes compute the per-body terms and the AMP row's dof entries, and lane
// 0 finishes. The outputs go straight into their own tensors.
#include <cuda_runtime.h>
#include <stddef.h>

#include "reward_amp.cuh"

using namespace hm;

// This translation unit's copy of the env constants (ra_set_consts).
static __constant__ EnvConsts c_env;

constexpr int kRaEnvs = 8;   // envs (warps) a block
// Resident blocks an SM the registers must allow: 3 x 132 SMs hold the 384
// blocks of 3072 envs in one wave (at most 85 registers a thread).
constexpr int kRaMinBlocks = 3;

__global__ void __launch_bounds__(kRaEnvs * 32, kRaMinBlocks) reward_amp_kernel(RaIn in, RaOut out, int B) {
  __shared__ RaEnv envs[kRaEnvs];
  const int w = threadIdx.x / 32;
  const int e = blockIdx.x * kRaEnvs + w;
  if (e >= B) return;   // the whole warp: no other warp waits for it
  reward_amp_env(Lanes<32>{(int)(threadIdx.x % 32), 0xffffffffu}, c_env, in, out, e, envs[w]);
}

extern "C" {

size_t ra_env_consts_bytes() { return sizeof(EnvConsts); }

// Upload this unit's copy of the env table on `stream`.
int ra_set_consts(const void* env, size_t env_bytes, void* stream) {
  if (env_bytes != sizeof(EnvConsts)) return -1;
  cudaMemcpyToSymbolAsync(c_env, env, env_bytes, 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// in[10] / in_stride[10]: RaIn's tensors and env strides (floats); out[5] /
// out_stride[5]: reward, raw, dist mean, dist max, AMP row.
int ra_reward_amp(const void* const* in, const long long* in_stride, void* const* out,
                  const long long* out_stride, int B, void* stream) {
  RaIn x;
  RaOut y;
  for (int k = 0; k < kRaInputs; ++k) {
    x.p[k] = (const float*)in[k];
    x.stride[k] = in_stride[k];
  }
  for (int k = 0; k < 5; ++k) {
    y.p[k] = (float*)out[k];
    y.stride[k] = out_stride[k];
  }
  if (B > 0)
    reward_amp_kernel<<<(B + kRaEnvs - 1) / kRaEnvs, kRaEnvs * 32, 0, (cudaStream_t)stream>>>(x, y, B);
  return (int)cudaGetLastError();
}

// Launch geometry of RA at B envs into info[4]: blocks, threads a block,
// shared bytes a block, resident blocks an SM.
int ra_kernel_info(int B, int* info) {
  info[0] = (B + kRaEnvs - 1) / kRaEnvs;
  info[1] = kRaEnvs * 32;
  info[2] = (int)(kRaEnvs * sizeof(RaEnv));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], reward_amp_kernel, kRaEnvs * 32, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
