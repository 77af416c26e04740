"""The plain reference against the program's plain CPU path, at tiny widths:
the parameter layout, the data path, the grids of each of the four
serving workflows, and training steps in both texture encoders."""
import numpy as np
import pytest
import torch

from conftest import tiny_cell
from benchmark import harness, port
from benchmark.reference import data as ref_data
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train
from benchmark.reference.model import Reference, leaf_specs, make_weights
from pctd_tpu_torch.config import tiny_model_config
from pctd_tpu_torch.data.tensorize import tensorize_batch
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.utils.weights import named_leaves

CPU = torch.device("cpu")


@pytest.mark.parametrize("encoder", ["conv", "pianotree"])
def test_parameter_layout_is_the_programs(encoder):
    cell = tiny_cell(f"{encoder}-train-b512")
    mine = {n: s for n, s, _ in leaf_specs(cell.widths)}
    theirs = named_leaves(dv.init_params(
        tiny_model_config(txt_encoder=encoder), seed=0, device="cpu"))
    assert mine == {n: tuple(t.shape) for n, t in theirs.items()}
    w = make_weights(cell.widths, 5, CPU)
    assert [tuple(t.shape) for t in w.values()] == list(mine.values())
    same = make_weights(cell.widths, 5, CPU)
    assert all(torch.equal(w[k], same[k]) for k in w)
    tree = port.params_tree(w)
    assert all(a is b for a, b in zip(named_leaves(tree).values(),
                                       w.values()))


@pytest.mark.parametrize("encoder", ["conv", "pianotree"])
def test_data_path_equals_program(encoder):
    cell = tiny_cell(f"{encoder}-train-b512")
    segments = harness.load_module("traffic", "train").segments
    pr, chord = segments(np.random.default_rng(3), 24, 0.05, 0.6)
    shift = np.arange(24, dtype=np.int32) % 12 - 6
    raw = [torch.as_tensor(a) for a in (pr, chord, shift)]
    mine = ref_data.features(*raw, cell.widths)
    theirs = tensorize_batch(*raw, with_detrend=encoder == "pianotree")
    assert set(mine) == set(theirs)
    for k in mine:
        assert torch.equal(mine[k].to(theirs[k].dtype), theirs[k]), k


def _served(cell, seed: int):
    """Every request of a tiny deck through the program's Sampler on the
    CPU: [(request with its seed, grid)] and the weights."""
    drv = harness.load_module("traffic", "serve").Driver(cell, seed, CPU)
    drv.setup()
    out = []
    for i, req in enumerate(drv.deck):
        grid = harness.load_module("traffic", "serve").send(
            drv.sampler, req, 1000 + i, CPU)
        out.append((dict(req, seed=1000 + i), grid))
    return drv.weights, out


@pytest.mark.parametrize("kind", ["swap", "posterior_sample",
                                  "prior_sample", "interp"])
def test_served_grids_equal_program(kind):
    cell = tiny_cell("conv-serve-songs")
    cell = cell._replace(mix=dict(cell.mix, deck=6, workflows={kind: 1.0}))
    weights, served = _served(cell, 17)
    ref = Reference(weights, cell.widths)
    with torch.no_grad():
        for req, grid in served:
            z = ref_serve.latents(ref, req, CPU)
            g = torch.as_tensor(grid).reshape(-1, *grid.shape[-3:])
            top = ref_serve.argmax_grid(*ref.decode_served(z, g))
            assert torch.equal(top, g.long()), req["args"]
    assert ref_serve.served_gap(ref, served, CPU) < 1e-5


@pytest.mark.parametrize("encoder", ["conv", "pianotree"])
def test_training_steps_equal_program(encoder):
    cell = tiny_cell(f"{encoder}-train-b512")
    drv = harness.load_module("traffic", "train").Driver(cell, 23, CPU)
    drv.setup()
    drv.release()
    nums = drv._numbers(drv._reference())
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-5


def test_schedules_and_noise_are_the_programs():
    from pctd_tpu_torch.train import schedules
    cell = tiny_cell("conv-train-b512")
    s = ref_train.settings_of(cell.mix)
    tcfg = port.TrainConfig()
    for step in (0, 1, 2, 7):
        assert ref_train.schedules_at(step, s) == schedules.train_params_at(
            step, tcfg)
        assert ref_train.lr_at(step, s) == schedules.lr_at(step, tcfg)
    sched = ref_train.schedules_at(0, s)
    mine = ref_train.draw_noise(torch.Generator().manual_seed(9),
                                cell.widths, 5, sched)
    theirs = dv.draw_noise(torch.Generator().manual_seed(9),
                           port.model_config(cell.config), 5,
                           sched["tfr1"], sched["tfr2"], sched["tfr3"])
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
