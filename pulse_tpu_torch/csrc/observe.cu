// K2: the imitation env's observation, self obs v1 ++ task obs v6 (one
// future step), one thread per (env, body) pair (observe.cuh observe_body).
//
// Replaces the TPU kernel pulse_tpu/env/pallas_obs.py:pallas_observe (body
// _build_obs_kernel). Plain version:
// pulse_tpu_torch/env/cuda_obs.py:observe_plain.
//
// Bound on the H100: by bytes. An env reads 624 floats and writes 934, with
// ~16,000 float operations, so the kernel streams. The design keeps enough
// loads in flight to stream: B J threads (73,728 at 3072 envs, 576 blocks of
// 128), pair i = e J + b, body fastest, so a warp's loads of one field are
// consecutive addresses of the [B, J, *] tensors, read in place through a
// pointer and an env stride each. Each pair reads its env's root (from L1:
// 24 neighbouring threads read it) and writes its body's entries straight
// into the env-major [B, obs_dim] observation. No shared memory, no
// reduction.
#include <cuda_runtime.h>

#include "observe.cuh"

using namespace hm;

constexpr int kObsBlock = 128;

__global__ void __launch_bounds__(kObsBlock) observe_kernel(ObsIn in, float* __restrict__ out, long long ld,
                                                            int task_col, int B, int J, int local_root_obs,
                                                            int root_height_obs) {
  const int i = blockIdx.x * kObsBlock + threadIdx.x;
  if (i >= B * J) return;
  const int e = i / J;
  observe_body(in, e, i - e * J, J, local_root_obs, root_height_obs, RowsOut{out + e * ld, 1}, task_col);
}

extern "C" {

// in[8] / in_stride[8]: ObsIn's tensors and env strides (floats); out: the
// [B, >= task_col + 24 J] observation, row stride `ld` floats; the self obs
// goes to columns [0, self_obs_dim), the task obs from column task_col.
int k2_observe(const void* const* in, const long long* in_stride, float* out, long long ld, int task_col, int B,
               int J, int local_root_obs, int root_height_obs, void* stream) {
  ObsIn x;
  for (int k = 0; k < kObsInputs; ++k) {
    x.p[k] = (const float*)in[k];
    x.stride[k] = in_stride[k];
  }
  const int n = B * J;
  if (n > 0)
    observe_kernel<<<(n + kObsBlock - 1) / kObsBlock, kObsBlock, 0, (cudaStream_t)stream>>>(
        x, out, ld, task_col, B, J, local_root_obs, root_height_obs);
  return (int)cudaGetLastError();
}

// Launch geometry of K2 at B envs of J bodies into info[4]: blocks, threads
// a block, shared bytes a block, resident blocks an SM.
int k2_kernel_info(int B, int J, int* info) {
  info[0] = (B * J + kObsBlock - 1) / kObsBlock;
  info[1] = kObsBlock;
  info[2] = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], observe_kernel, kObsBlock, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
