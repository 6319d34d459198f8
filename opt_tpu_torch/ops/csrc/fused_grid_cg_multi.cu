// The MULTI instances of fused_grid_cg_kernel (fused_grid_cg.cuh): all 32
// (lm, rem, cs, block, bf16) combinations of the form, in a unit of their
// own so that nvcc builds the three forms in parallel processes.

#include "fused_grid_cg.cuh"

extern "C" const void* fused_grid_cg_multi_instance(const int* flags) {
  return form_instance<FGCG_MULTI>(flags);
}
