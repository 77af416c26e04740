// The bf16 entry point of the serving decode kernel K3: frame_group_kernel
// of decoder.cu instantiated for __nv_bfloat16, in a translation unit of its
// own so that nvcc builds it beside the float kernels.
#define PCTD_DECODE_BF16
#include "decoder.cu"
