// K1: the whole pre-merge env step of the imitation env in one launch, one
// thread per env: steps_per_control physics substeps and the final FK
// (physics_step.cuh, the model from its table), then the imitation reward
// with its four raw terms, the mean/max termination distance over the reset
// bodies, and the AMP discriminator row of the stepped state
// (reward_amp.cuh).
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_step_reward_amp
// (physics body substep_pallas._build_kernel, epilogue _reward_amp_tiles).
// Plain version: pulse_tpu_torch/env/cuda_obs.py:step_reward_amp_plain.
//
// Bound on the H100: by operations, not bytes. An env reads 555 floats and
// writes 797 (~5.4 KB), but runs 4 substeps of the articulated-body
// algorithm over 24 bodies, tens of thousands of float operations. The
// design keeps it simple: one thread per env, the model in constant memory,
// inputs and outputs in [rows, B] layout so neighbouring threads touch
// neighbouring addresses, the per-env scratch in local memory. At 3072 envs
// that is only 96 warps for 132 SMs: the card is under-filled, and spreading
// one env over a warp's lanes is later work.
#include <cuda_runtime.h>
#include <stddef.h>

#include "physics_step.cuh"
#include "reward_amp.cuh"

using namespace hm;

// This translation unit's copy of the env constants (c_model comes from
// physics_step.cuh); k1_set_consts uploads both.
static __constant__ EnvConsts c_env;

__global__ void __launch_bounds__(64) step_reward_amp_kernel(const float* __restrict__ in,
                                                             float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int J = c_model.J, Jm1 = J - 1;
  // input rows: state | pd target | reference bodies 13J
  const RowsIn x{in + e, B};
  PhysState s;
  V3 pd[MAX_J - 1];
  read_step_inputs(J, x, s, pd);

  V3 contact[MAX_J];
  WorldBodies wb;
  control_step(TableView{&c_model}, s, pd, contact, wb);

  // output rows: state | contact 3J | bodies 13J | reward/AMP block
  const int n_state = state_rows(J);
  write_step_outputs(J, RowsOut{out + e, B}, s, contact, wb);
  const RowsIn ref{in + e + (size_t)(n_state + 3 * Jm1) * B, B};
  reward_amp(c_env, wb.pos, wb.rot, wb.vel, wb.ang, s.jrot, s.omega, ref,
             RowsOut{out + e + (size_t)(n_state + 16 * J) * B, B});
}

extern "C" {

size_t k1_model_consts_bytes() { return sizeof(ModelConsts); }
size_t k1_env_consts_bytes() { return sizeof(EnvConsts); }

// Upload the model and env constant tables (once per model) on `stream`.
int k1_set_consts(const void* model, size_t model_bytes, const void* env, size_t env_bytes,
                  void* stream) {
  if (model_bytes != sizeof(ModelConsts) || env_bytes != sizeof(EnvConsts)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyToSymbolAsync(c_model, model, model_bytes, 0, cudaMemcpyHostToDevice, st);
  cudaMemcpyToSymbolAsync(c_env, env, env_bytes, 0, cudaMemcpyHostToDevice, st);
  return (int)cudaGetLastError();
}

// in: [555, B] f32, out: [797, B] f32 at the SMPL humanoid's J = 24.
int k1_step_reward_amp(const float* in, float* out, int B, int block, void* stream) {
  step_reward_amp_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(in, out, B);
  return (int)cudaGetLastError();
}

const char* k_error_string(int code) {
  return code < 0 ? "constant table size mismatch" : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
