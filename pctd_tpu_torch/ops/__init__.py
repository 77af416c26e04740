"""Low-level compute: scan GRUs, distributions, losses, the CUDA kernels."""
from pctd_tpu_torch.ops.distributions import (DiagNormal,  # noqa: F401
                                              kl_std_normal)
from pctd_tpu_torch.ops.gru import (GRUParams, bigru_last,  # noqa: F401
                                    bigru_last_masked, gru_cell_pre,
                                    gru_gates_pre, gru_init, gru_scan,
                                    input_proj)
