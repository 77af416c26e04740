// The bf16 entry points of the train-frame kernels K1, K2a and K2b: the
// templates of train_frame.cu instantiated for __nv_bfloat16, in a
// translation unit of their own so that nvcc builds them beside the float
// ones.
#define PCTD_TRAIN_BF16
#include "train_frame.cu"
