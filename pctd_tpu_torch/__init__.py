"""pctd_tpu_torch — the PyTorch/CUDA port of pctd_tpu for NVIDIA Hopper.

The JAX package ``pctd_tpu`` is the reference this port is held against.
The port imports ``torch`` and numpy only: nothing of ``jax`` and nothing
of ``pctd_tpu`` (the machine with the card has no JAX), so it keeps its own
copy of what it needs, ``config.py`` included.

Layout mirrors ``pctd_tpu`` so each module's counterpart is easy to find:

- ``pctd_tpu_torch.ops``      GRU ops, distributions, losses, and the
                              hand-written CUDA kernels (``ops.kernels``)
- ``pctd_tpu_torch.models``   chord/texture encoders, the chord decoder, the
                              PianoTree decoder, the latent-control API and
                              loss, and the fixed-batch ``Sampler``
- ``pctd_tpu_torch.data``     the corpus pipeline (score, corpus, synthetic
                              songs), on-device tensorize and detrend, and
                              the batch loaders
- ``pctd_tpu_torch.train``    schedules, clip + Adam, train/eval steps, the
                              ``Trainer`` and its epoch loop, checkpoints and
                              metric writers
- ``pctd_tpu_torch.cli``      ``python -m pctd_tpu_torch.cli.train`` and
                              ``...cli.evaluate``
- ``pctd_tpu_torch.utils``    init distributions, the weight bridge from the
                              JAX parameter tree, device selection and memory

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from pctd_tpu_torch.config import ModelConfig  # noqa: F401
