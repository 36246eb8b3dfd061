// K3: the humanoid physics control step with no epilogue, one thread per
// env: steps_per_control substeps and the final FK (physics_step.cuh, the
// same per-env code as K1), writing the stepped state, the substep-mean
// contact force and the world bodies. K3-rows: the same step with each
// env's own model.
//
// Replaces the TPU kernel pulse_tpu/physics/substep_pallas.py:
// pallas_physics_step (body _build_kernel without its `extra` hook): K3 its
// shared-model form, the model this unit's constant table; K3-rows its
// `model_rows` form (_model_rows_layout, _model_tiles), the per-env values
// read from a [n_model, B] block of model rows (RowsView) and only the
// topology and config from the table. Plain versions:
// pulse_tpu_torch/physics/step.py:physics_step on the shared model, and on
// the batched model the rows hold (physics/substep_cuda.py model_from_rows).
//
// Bound on the H100: by operations, as K1 (K3 reads 243 floats an env and
// writes 558, K3-rows reads 859 model floats more, and both run 4
// articulated-body substeps over 24 bodies). The design is K1's: one
// thread per env, [rows, B] layout, per-env scratch in local memory. It
// also runs the getup env's fall-state settle at B = 256 ragdolls, where 8
// warps leave most of the card idle. K3-rows reads each per-env model value
// from global memory where the step uses it, without staging the rows in
// per-thread arrays (they would add ~3.4 KB to the 12 KB local stack).
#include <cuda_runtime.h>
#include <stddef.h>

#include "physics_step.cuh"

using namespace hm;

template <class View>
__device__ __forceinline__ void step_one_env(const View& m, const float* __restrict__ in, float* __restrict__ out,
                                             int e, int B) {
  const int J = c_model.J;
  PhysState s;
  V3 pd[MAX_J - 1];
  read_step_inputs(J, RowsIn{in + e, B}, s, pd);
  V3 contact[MAX_J];
  WorldBodies wb;
  control_step(m, s, pd, contact, wb);
  write_step_outputs(J, RowsOut{out + e, B}, s, contact, wb);
}

__global__ void __launch_bounds__(64) physics_step_kernel(const float* __restrict__ in,
                                                          float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  step_one_env(TableView{&c_model}, in, out, e, B);
}

__global__ void __launch_bounds__(64) physics_step_rows_kernel(const float* __restrict__ in,
                                                               const float* __restrict__ rows,
                                                               float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  step_one_env(RowsView(&c_model, RowsIn{rows + e, B}), in, out, e, B);
}

extern "C" {

size_t k3_model_consts_bytes() { return sizeof(ModelConsts); }

// Upload this unit's copy of the model table (once per model) on `stream`.
int k3_set_consts(const void* model, size_t model_bytes, void* stream) {
  if (model_bytes != sizeof(ModelConsts)) return -1;
  cudaMemcpyToSymbolAsync(c_model, model, model_bytes, 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// in: [243, B] f32 (state | pd target), out: [558, B] f32 (state | contact
// | bodies) at the SMPL humanoid's J = 24.
int k3_physics_step(const float* in, float* out, int B, int block, void* stream) {
  physics_step_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(in, out, B);
  return (int)cudaGetLastError();
}

// K3-rows. in and out as K3's; rows: [859, B] f32 per-env model rows
// (model_rows_layout at J = 24, P = 68).
int k3_physics_step_rows(const float* in, const float* rows, float* out, int B, int block, void* stream) {
  physics_step_rows_kernel<<<(B + block - 1) / block, block, 0, (cudaStream_t)stream>>>(in, rows, out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
