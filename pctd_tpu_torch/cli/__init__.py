"""Command-line entry points: ``python -m pctd_tpu_torch.cli.train`` and
``python -m pctd_tpu_torch.cli.evaluate``."""
