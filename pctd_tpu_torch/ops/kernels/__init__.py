"""Hand-written CUDA kernels of the serving decode, each beside its plain
PyTorch version: K3 (:mod:`.ar_decoder`, one frame) and K4
(:mod:`.full_decoder`, the whole decode). Sources are in ``csrc/``;
:mod:`.build` compiles them with ``nvcc`` at first use on the card."""
