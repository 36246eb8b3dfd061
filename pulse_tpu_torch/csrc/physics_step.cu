// K3: the humanoid physics control step with no epilogue: steps_per_control
// substeps and the final FK (physics_step.cuh, the same per-env code as K1),
// writing the stepped state, the substep-mean contact force and the world
// bodies. K3-rows: the same step with each env's own model.
//
// Replaces the TPU kernel pulse_tpu/physics/substep_pallas.py:
// pallas_physics_step (body _build_kernel without its `extra` hook): K3 its
// shared-model form, the model this unit's constant table; K3-rows its
// `model_rows` form (_model_rows_layout, _model_tiles), the per-env values
// read from the env's [n_model] record of model rows (RowsView) and only the
// topology and config from the table. Plain versions:
// pulse_tpu_torch/physics/step.py:physics_step on the shared model, and on
// the batched model the rows hold (physics/substep_cuda.py model_from_rows).
//
// Bound on the H100: by operations, as K1 (K3 reads 243 floats an env and
// writes 558, K3-rows reads 859 model floats more, and both run 4
// articulated-body substeps over 24 bodies, ~223k operations an env). The
// design is K1's: a group of G lanes steps one env through the phases of
// physics_step.cuh, the env's working set in shared memory, so that 3072
// envs are 3072 G lanes in flight rather than 96 warps, and the lanes split
// each level's bodies, the joints and the contact points. Records are
// env-major ([B, rows]), so a group reads and writes its env's contiguously.
// K3-rows stages the env's hot model rows (lt, mass, com, Isym, 1.2 KB) in
// shared memory beside the working set and reads the rest where it is used.
// K3 also runs the getup env's fall-state settle at B = 256 ragdolls.
#include <cuda_runtime.h>
#include <stddef.h>

#include "physics_step.cuh"

using namespace hm;

// `table`: c_model's global address, for the lanes' scattered reads.
template <int G, bool kRows>
__global__ void __launch_bounds__(kEnvsPerBlock * G) physics_step_kernel(const ModelConsts* __restrict__ table,
                                                                        const float* __restrict__ in,
                                                                        const float* __restrict__ rows,
                                                                        float* __restrict__ out, int B) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / G;
  const int e = blockIdx.x * kEnvsPerBlock + g;
  const bool live = e < B;
  const size_t ee = live ? e : B - 1;   // a group past the batch steps env B - 1 and writes nothing
  Work& w = reinterpret_cast<Work*>(smem)[g];
  const Lanes<G> run{(int)(threadIdx.x % G), group_mask<G>()};
  const int J = c_model.J;
  const int n_in = state_rows(J) + 3 * (J - 1), n_out = state_rows(J) + 16 * J;
  const RowsIn x{in + ee * n_in, 1};
  const RowsOut y{out + ee * n_out, 1};
  if constexpr (kRows) {
    const int n_model = 13 * J + 9 * (J - 1) + 5 * c_model.P;
    const RowsIn m{rows + ee * n_model, 1};
    float* hot = reinterpret_cast<float*>(reinterpret_cast<Work*>(smem) + kEnvsPerBlock) + g * kHotRows;
    run([&](int lane) { stage_hot_rows<G>(J, m, hot, lane); });
    step_env(run, RowsView(&c_model, table, hot, m), w, x, y, live);
  } else {
    step_env(run, TableView{&c_model, table}, w, x, y, live);
  }
}

template <int G, bool kRows>
static size_t shared_bytes() {
  return kEnvsPerBlock * (sizeof(Work) + (kRows ? sizeof(float) * kHotRows : 0));
}

// Blocks above 48 KB of shared memory need the kernel's attribute raised.
template <int G, bool kRows>
static int launch(const float* in, const float* rows, float* out, int B, cudaStream_t stream) {
  constexpr int E = kEnvsPerBlock;
  const size_t smem = shared_bytes<G, kRows>();
  const ModelConsts* table = nullptr;
  cudaGetSymbolAddress((void**)&table, c_model);
  cudaFuncSetAttribute(physics_step_kernel<G, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (B > 0) physics_step_kernel<G, kRows><<<(B + E - 1) / E, E * G, smem, stream>>>(table, in, rows, out, B);
  return (int)cudaGetLastError();
}

// info: threads a block, envs a block, shared bytes a block, resident
// blocks an SM.
template <int G, bool kRows>
static int kernel_info(int* info) {
  constexpr int E = kEnvsPerBlock;
  const size_t smem = shared_bytes<G, kRows>();
  cudaFuncSetAttribute(physics_step_kernel<G, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  info[0] = E * G;
  info[1] = E;
  info[2] = (int)smem;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], physics_step_kernel<G, kRows>, E * G, smem);
  return (int)cudaGetLastError();
}

extern "C" {

size_t k3_model_consts_bytes() { return sizeof(ModelConsts); }
size_t k3_work_bytes() { return sizeof(Work); }

// Upload this unit's copy of the model table (once per model) on `stream`.
int k3_set_consts(const void* model, size_t model_bytes, void* stream) {
  if (model_bytes != sizeof(ModelConsts)) return -1;
  cudaMemcpyToSymbolAsync(c_model, model, model_bytes, 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// in: [B, 243] f32 (state | pd target), out: [B, 558] f32 (state | contact
// | bodies) at the SMPL humanoid's J = 24; `group` lanes an env, one of
// HM_GROUPS.
int k3_physics_step(const float* in, float* out, int B, int group, void* stream) {
  switch (group) {
#define HM_CASE(G) \
  case G: return launch<G, false>(in, nullptr, out, B, (cudaStream_t)stream);
    HM_GROUPS(HM_CASE)
#undef HM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K3-rows. in and out as K3's; rows: [B, 859] f32 per-env model rows
// (model_rows_layout at J = 24, P = 68).
int k3_physics_step_rows(const float* in, const float* rows, float* out, int B, int group, void* stream) {
  switch (group) {
#define HM_CASE(G) \
  case G: return launch<G, true>(in, rows, out, B, (cudaStream_t)stream);
    HM_GROUPS(HM_CASE)
#undef HM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Launch geometry of K3 (rows 0) or K3-rows (rows 1) at `group` into info[4].
int k3_kernel_info(int group, int rows, int* info) {
  switch (group) {
#define HM_CASE(G) \
  case G: return rows ? kernel_info<G, true>(info) : kernel_info<G, false>(info);
    HM_GROUPS(HM_CASE)
#undef HM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
