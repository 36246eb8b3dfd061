// K1: the whole pre-merge env step of the imitation env in one launch:
// steps_per_control physics substeps and the final FK (physics_step.cuh,
// the model from its table), then the imitation reward with its four raw
// terms, the mean/max termination distance over the reset bodies, and the
// AMP discriminator row of the stepped state (reward_amp.cuh).
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_step_reward_amp
// (physics body substep_pallas._build_kernel, epilogue _reward_amp_tiles).
// Plain version: pulse_tpu_torch/env/cuda_obs.py:step_reward_amp_plain.
//
// Bound on the H100: by operations, not bytes. An env reads 555 floats and
// writes 797 (~5.4 KB), but runs 4 substeps of the articulated-body
// algorithm over 24 bodies, ~228k float operations, most of them in long
// dependent chains. The design fills the card with independent work: a
// group of G lanes steps one env (physics_step.cuh), splitting each phase's
// bodies, joints or contact points, with the env's working set in shared
// memory; the model table is read through the constant cache where the
// lanes read alike and through L1 where each reads its own body, and
// records are env-major ([B, rows]) so a group reads and writes its env's
// contiguously. The
// epilogue (~2% of the work) runs on the world bodies the physics left in
// shared memory: the AMP row's dof entries (phase b of reward_amp.cuh, half
// of its work) over the group's lanes, the rest on its first lane; it is
// the same code RA runs.
#include <cuda_runtime.h>
#include <stddef.h>

#include "physics_step.cuh"
#include "reward_amp.cuh"

using namespace hm;

// This translation unit's copy of the env constants (c_model comes from
// physics_step.cuh); k1_set_consts uploads both.
static __constant__ EnvConsts c_env;

// `table`: c_model's global address, for the lanes' scattered reads.
template <int G>
__global__ void __launch_bounds__(kEnvsPerBlock * G) step_reward_amp_kernel(const ModelConsts* __restrict__ table,
                                                                           const float* __restrict__ in,
                                                                           float* __restrict__ out, int B,
                                                                           int n_out) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / G;
  const int e = blockIdx.x * kEnvsPerBlock + g;
  const bool live = e < B;
  const size_t ee = live ? e : B - 1;   // a group past the batch steps env B - 1 and writes nothing
  Work& w = reinterpret_cast<Work*>(smem)[g];
  const Lanes<G> run{(int)(threadIdx.x % G), group_mask<G>()};
  const int J = c_model.J, Jm1 = J - 1, n_state = state_rows(J);
  // input rows: state | pd target | reference bodies 13J
  const int n_in = n_state + 3 * Jm1 + 13 * J;
  const float* x = in + ee * n_in;
  float* y = out + ee * n_out;
  step_env(run, TableView{&c_model, table}, w, RowsIn{x, 1}, RowsOut{y, 1}, live);
  // output rows: state | contact 3J | bodies 13J | reward/AMP block; the
  // group's lanes split the AMP row's dof tan-norms
  if (live)
    reward_amp(c_env, w.y.wb.pos, w.y.wb.rot, w.y.wb.vel, w.y.wb.ang, w.jrot, w.omega,
               RowsIn{x + n_state + 3 * Jm1, 1}, RowsOut{y + n_state + 16 * J, 1}, run.lane, G);
}

template <int G>
static size_t shared_bytes() { return kEnvsPerBlock * sizeof(Work); }

template <int G>
static int launch(const float* in, float* out, int B, int n_out, cudaStream_t stream) {
  constexpr int E = kEnvsPerBlock;
  const size_t smem = shared_bytes<G>();
  const ModelConsts* table = nullptr;
  cudaGetSymbolAddress((void**)&table, c_model);
  cudaFuncSetAttribute(step_reward_amp_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (B > 0) step_reward_amp_kernel<G><<<(B + E - 1) / E, E * G, smem, stream>>>(table, in, out, B, n_out);
  return (int)cudaGetLastError();
}

// info: threads a block, envs a block, shared bytes a block, resident
// blocks an SM.
template <int G>
static int kernel_info(int* info) {
  constexpr int E = kEnvsPerBlock;
  const size_t smem = shared_bytes<G>();
  cudaFuncSetAttribute(step_reward_amp_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  info[0] = E * G;
  info[1] = E;
  info[2] = (int)smem;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], step_reward_amp_kernel<G>, E * G, smem);
  return (int)cudaGetLastError();
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

// in: [B, 555] f32, out: [B, n_out] f32 (797 at the SMPL humanoid's J = 24
// with the default AMP row); `group` lanes an env, one of HM_GROUPS.
int k1_step_reward_amp(const float* in, float* out, int B, int n_out, int group, void* stream) {
  switch (group) {
#define HM_CASE(G) \
  case G: return launch<G>(in, out, B, n_out, (cudaStream_t)stream);
    HM_GROUPS(HM_CASE)
#undef HM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Launch geometry of K1 at `group` into info[4].
int k1_kernel_info(int group, int* info) {
  switch (group) {
#define HM_CASE(G) \
  case G: return kernel_info<G>(info);
    HM_GROUPS(HM_CASE)
#undef HM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* k_error_string(int code) {
  return code < 0 ? "constant table size mismatch" : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
