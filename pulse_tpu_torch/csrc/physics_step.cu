// K3: the humanoid physics control step with no epilogue, one thread per
// env: steps_per_control substeps and the final FK (physics_step.cuh, the
// same per-env code as K1), writing the stepped state, the substep-mean
// contact force and the world bodies.
//
// Replaces the TPU kernel pulse_tpu/physics/substep_pallas.py:
// pallas_physics_step (body _build_kernel without its `extra` hook, shared
// model). Plain version: pulse_tpu_torch/physics/step.py:physics_step. The
// per-env model rows of the TPU kernel (shape variation, prop DR) are not
// ported: the model is this unit's constant table.
//
// Bound on the H100: by operations, as K1 (reads 243 floats an env, writes
// 558, and runs 4 articulated-body substeps over 24 bodies). The design is
// K1's: one thread per env, [rows, B] layout, model in constant memory,
// per-env scratch in local memory. It also runs the getup env's fall-state
// settle at B = 256 ragdolls, where 8 warps leave most of the card idle.
#include <cuda_runtime.h>
#include <stddef.h>

#include "physics_step.cuh"

using namespace hm;

__global__ void __launch_bounds__(64) physics_step_kernel(const float* __restrict__ in,
                                                          float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  PhysState s;
  V3 pd[MAX_J - 1];
  read_step_inputs(RowsIn{in + e, B}, s, pd);
  V3 contact[MAX_J];
  WorldBodies wb;
  control_step(s, pd, contact, wb);
  write_step_outputs(RowsOut{out + e, B}, s, contact, wb);
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

}  // extern "C"
