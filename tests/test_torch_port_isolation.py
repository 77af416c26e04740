"""pctd_tpu_torch stands alone: the machine with the card has no JAX, so the
port and chip_smoke.py must import with ``jax`` and ``pctd_tpu`` refused,
and without a card nothing falls back to the CPU on its own."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "pctd_tpu"):
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import pctd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pctd_tpu_torch.__path__,
                                               "pctd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("data.loaders", "data.tensorize", "models.chord_decoder",
             "models.disentangle_vae", "models.pianotree_decoder",
             "ops.kernels.train_frame", "ops.losses", "train.optim",
             "train.schedules", "train.trainer"):
    assert "pctd_tpu_torch." + name in names, name
import chip_smoke  # noqa: F401
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pctd_tpu"))
assert not leaked, leaked

import torch
from pctd_tpu_torch.config import tiny_model_config
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models.sampler import Sampler
assert not torch.cuda.is_available()
params = dv.init_params(tiny_model_config(), seed=0, device="cpu")
from pctd_tpu_torch.config import TrainConfig
from pctd_tpu_torch.train.trainer import Trainer
for call in (lambda: Sampler(params, tiny_model_config()),
             lambda: dv.init_params(tiny_model_config()),
             lambda: Trainer(tiny_model_config(), TrainConfig(), None)):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("ran without a card and without device='cpu'")
# the logits-out training path runs on the CPU with jax refused
import numpy as np
from pctd_tpu_torch.data.loaders import SegmentCorpus, make_loaders
pr = np.zeros((2, 32, 128), np.uint8)
pr[:, ::4, 60:64] = 2
chord = np.zeros((2, 8, 14), np.float32)
train_b, _ = make_loaders(SegmentCorpus(pr, chord), SegmentCorpus(pr, chord),
                          batch_size=2)
run = Trainer(tiny_model_config(fused_loss=False), TrainConfig(batch_size=2),
              train_b, device="cpu", params=params)
assert np.isfinite(run.train_steps(1)[0]["loss"])
print("modules", len(names))
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    proc = _run(["-c", PROBE])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 28


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
