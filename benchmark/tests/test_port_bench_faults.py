"""The comparison that decides ``correct``, shown to fail: whole runs of
the harness at tiny widths on the CPU (the look for a card skipped), with
the program's timed path broken underneath, must print ``correct``
false; the sound run true. The lower-precision control (TF32, emulated
off the card) must miss a limit; on the card, at the cell's own size,
the same control runs in TF32."""
import io
import json
import time

import pytest
import torch

from conftest import cells, tiny_cell, tiny_overrides
from benchmark import harness
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.ops.kernels import full_decoder
from pctd_tpu_torch.train import optim, trainer

SERVE = [c for c in cells() if "serve" in c]
TRAIN = [c for c in cells() if "train" in c]


def _run(cell: str, trace: bool = False) -> dict:
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, 2 ** 31 + 5, 0.2, trace, time.perf_counter(),
                          device="cpu", overrides=tiny_overrides(cell),
                          out=out, err=err)
    assert rc == 0, err.getvalue()
    lines = err.getvalue().strip().splitlines()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert len(lines) >= len(result["checks"])
    return result


def _decode_altered(plain):
    def decode(*args):
        grid = plain(*args).clone()
        grid[0, 0, 0, 0] = (grid[0, 0, 0, 0] + 1) % 130
        return grid
    return decode


def _decode_half(plain):
    """Half of the rows left out: each odd row gets its even neighbour's
    grid."""
    def decode(fw, spec, h0, *rest):
        grid = plain(fw, spec, h0[::2], *(r[::2] for r in rest))
        return grid.repeat_interleave(2, 0)[:h0.shape[0]]
    return decode


@pytest.mark.parametrize("cell", SERVE)
def test_serving_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("fault", [_decode_altered, _decode_half])
@pytest.mark.parametrize("cell", SERVE)
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(full_decoder, "decode_grid_full_plain",
                        fault(full_decoder.decode_grid_full_plain))
    assert _run(cell)["correct"] is False


def _unchanged(self, grads, scalars=None):
    return optim.global_norm(grads)


def _half_batch(loss):
    def half(params, mcfg, x, c, pr_mat, noise, *a, dt_x=None, **kw):
        h = max(1, x.shape[0] // 2)
        noise = noise._replace(eps_chd=noise.eps_chd[:h],
                               eps_rhy=noise.eps_rhy[:h])
        return loss(params, mcfg, x[:h], c[:h], pr_mat[:h], noise, *a,
                    dt_x=None if dt_x is None else dt_x[:h], **kw)
    return half


def _pitch_moved(features):
    def moved(pr, chord, shift, mcfg):
        x, c, pr_mat, dt_x = features(pr, chord, shift, mcfg)
        note = x[..., 0] < 128
        x = torch.where(note[..., None] & (torch.arange(6) == 0),
                        (x + 1) % 128, x)
        return x, c, pr_mat, dt_x
    return moved


@pytest.mark.parametrize("cell", TRAIN)
def test_training_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 2


@pytest.mark.parametrize("cell", TRAIN)
def test_training_state_unchanged_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(optim.Adam, "step", _unchanged)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_training_half_batch_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(dv, "loss", _half_batch(dv.loss))
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_training_token_altered_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(trainer, "batch_features",
                        _pitch_moved(trainer.batch_features))
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", cells())
def test_control_misses_a_limit(cell):
    """The reference in emulated TF32 in the program's place, at tiny
    widths: at least one number over its limit."""
    c = tiny_cell(cell)
    drv = harness.load_module("traffic", c.mix["driver"]).Driver(
        c, 31, torch.device("cpu"))
    drv.setup()
    run = harness.RunRecord(c, 0.1)
    run.window_t0 = time.perf_counter()
    drv.run_window(run)
    drv.release()
    got = drv.control(emulate=True)
    numbers = got if isinstance(got, float) else got["control"]
    if isinstance(numbers, float):
        numbers = {"logit_gap": numbers}
    assert any(numbers[k] > c.limits[k] for k in numbers), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_control_misses_a_limit_on_the_card(cell):
    """The same control on the card, in TF32, at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(cell)
    drv = harness.load_module("traffic", c.mix["driver"]).Driver(
        c, 37, torch.device("cuda"))
    drv.setup()
    run = harness.RunRecord(c, 2.0)
    run.window_t0 = time.perf_counter()
    drv.run_window(run)
    drv.release()
    harness.free_device_memory()
    got = drv.control()
    numbers = ({"logit_gap": got} if isinstance(got, float)
               else got["control"])
    assert any(numbers[k] > c.limits[k] for k in numbers), numbers
