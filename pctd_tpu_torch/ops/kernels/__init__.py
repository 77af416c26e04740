"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
serving decode K3 (:mod:`.ar_decoder`, one frame) and K4
(:mod:`.full_decoder`, the whole decode), and the training frame pair K1/K2
(:mod:`.train_frame`, forward with the fused CE and its backward). Sources
are in ``csrc/``; :mod:`.build` compiles them with ``nvcc`` at first use on
the card."""
