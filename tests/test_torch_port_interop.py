"""Reference ``.pt`` interop of the port (``utils/torch_interop.py`` and
``cli/convert_checkpoint.py``) against the JAX package's on the CPU at tiny
widths: reference-layout state dicts built in the process from the JAX
package's ``state_dict_from_params`` convert to port params bit-equal to
the JAX conversion, in both texture variants, with and without the
DataParallel ``module.`` prefix; the round trip is bit-exact; the CLI's
both directions, with the variant found where it is not given; and a
converted checkpoint serves the JAX package's grids."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.utils import torch_interop as jti
from pctd_tpu_torch.cli import convert_checkpoint, serve
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.train import checkpoint
from pctd_tpu_torch.utils import torch_interop as ti
from pctd_tpu_torch.utils.weights import export_params, named_leaves
from tests.test_torch_port_training import _named
from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, requests)

VARIANTS = ("conv", "pianotree")


def _cfgs(variant):
    return (dataclasses.replace(JAX_TINY, txt_encoder=variant),
            dataclasses.replace(TINY, txt_encoder=variant))


def _state_dict(variant, seed=0, prefix=""):
    """A reference-layout state dict (numpy values) of JAX-initialised
    weights, and those weights."""
    jp = jax_params(_cfgs(variant)[0], seed=seed)
    sd = jti.state_dict_from_params(jp)
    return {prefix + k: v for k, v in sd.items()}, jp


def _assert_same_tree(port_tree, jax_tree):
    got, want = _named(export_params(port_tree)), _named(jax_tree)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], np.asarray(arr),
                                      err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("values", ["numpy", "torch"])
def test_params_from_state_dict_equals_jax(variant, prefix, values):
    jcfg, cfg = _cfgs(variant)
    sd, _ = _state_dict(variant, seed=3, prefix=prefix)
    want = jti.params_from_state_dict(dict(sd), jcfg)
    if values == "torch":            # as torch.load returns them
        sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    got = ti.params_from_state_dict(sd, cfg, device="cpu")
    _assert_same_tree(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_round_trip_is_bit_exact(variant, tmp_path):
    _, cfg = _cfgs(variant)
    sd, jp = _state_dict(variant, seed=5)
    params = port_params(jp)
    out = ti.state_dict_from_params(params)
    assert sorted(out) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    pt = str(tmp_path / "ref.pt")
    ti.save_reference_checkpoint(pt, params)
    _assert_same_tree(ti.load_reference_checkpoint(pt, cfg, device="cpu"),
                      jp)


def test_variant_detection_and_cross_check():
    for variant in VARIANTS:
        sd, _ = _state_dict(variant)
        assert ti.detect_texture_variant(sd) == variant
        assert ti.detect_texture_variant(ti.strip_dataparallel(
            {"module." + k: v for k, v in sd.items()})) == variant
        other = "pianotree" if variant == "conv" else "conv"
        with pytest.raises(ValueError, match="texture variant"):
            ti.params_from_state_dict(sd, _cfgs(other)[1], device="cpu")
    with pytest.raises(ValueError, match="rhy_encoder"):
        ti.detect_texture_variant({"decoder.x": np.zeros(1)})


@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_cli_both_directions(variant, tmp_path):
    """--from-torch writes a checkpoint that load_model's reader takes
    (the variant found in the state dict), --to-torch writes its .pt back
    bit for bit (the variant found in the checkpoint), and --variant
    cross-checks."""
    _, cfg = _cfgs(variant)
    sd, jp = _state_dict(variant, seed=2, prefix="module.")
    src = str(tmp_path / "ref.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               src)
    ck = str(tmp_path / "ck")
    assert convert_checkpoint.main(
        ["--from-torch", src, "--out", ck, "--device", "cpu"],
        model_config=TINY) == ck
    saved = checkpoint.load_state(ck)
    assert checkpoint.model_config_of(saved) == cfg
    _assert_same_tree(checkpoint.params_of(saved, "cpu"), jp)

    back = str(tmp_path / "back.pt")
    convert_checkpoint.main(["--to-torch", back, "--checkpoint", ck,
                             "--device", "cpu"])
    got = torch.load(back, map_location="cpu", weights_only=True)
    assert ti.detect_texture_variant(got) == variant
    assert sorted(got) == sorted(k[len("module."):] for k in sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k[len("module."):]].numpy(), v)

    other = "pianotree" if variant == "conv" else "conv"
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["--from-torch", src, "--out", ck,
                                 "--variant", other, "--device", "cpu"],
                                model_config=TINY)
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["--to-torch", back, "--checkpoint", ck,
                                 "--variant", other, "--device", "cpu"])
    # --train-state is accepted for the JAX script's command lines and
    # changes nothing: a params-only checkpoint exports as before
    again = str(tmp_path / "again.pt")
    convert_checkpoint.main(["--to-torch", again, "--checkpoint", ck,
                             "--train-state", "--device", "cpu"])
    got2 = torch.load(again, map_location="cpu", weights_only=True)
    assert sorted(got2) == sorted(got)
    for k, v in got.items():
        assert torch.equal(got2[k], v)
    with pytest.raises(SystemExit, match="widths"):   # canonical config
        convert_checkpoint.main(["--from-torch", src, "--out", ck,
                                 "--device", "cpu"])


def test_convert_cli_finds_the_variant_of_a_train_state(tmp_path):
    """A run's checkpoint of the pianotree variant saved without a model
    configuration: --to-torch finds the variant from its params (the JAX
    CLI tries conv, then pianotree)."""
    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.train.optim import Adam

    _, cfg = _cfgs("pianotree")
    jp = jax_params(_cfgs("pianotree")[0], seed=1)
    params = port_params(jp)
    leaves = list(named_leaves(params).values())
    ck = str(tmp_path / "run_ck")
    checkpoint.save_state(ck, params, Adam(leaves, TrainConfig()), 0,
                          torch.Generator().manual_seed(0))
    assert checkpoint.model_config_of(checkpoint.load_state(ck)) is None
    out = str(tmp_path / "out.pt")
    convert_checkpoint.main(["--to-torch", out, "--checkpoint", ck,
                             "--train-state", "--device", "cpu"])
    sd = torch.load(out, map_location="cpu", weights_only=True)
    assert ti.detect_texture_variant(sd) == "pianotree"
    _assert_same_tree(ti.params_from_state_dict(sd, cfg, device="cpu"), jp)


def test_converted_checkpoint_serves_the_jax_grids(tmp_path):
    """A .pt converted in by the CLI, loaded by the serving CLIs' reader,
    decodes the JAX package's grids on the same weights; a pianotree one
    is refused there with the reason."""
    sd, jp = _state_dict("conv", seed=4)
    src = str(tmp_path / "ref.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               src)
    ck = str(tmp_path / "ck")
    convert_checkpoint.main(["--from-torch", src, "--out", ck, "--device",
                             "cpu"], model_config=TINY)
    params, cfg = checkpoint.load_model(ck, None, 0, "cpu")
    pr, c = requests(5, seed=2)
    got = Sampler(params, cfg, device="cpu").swap(pr, pr[::-1], c, c[::-1],
                                                  fix_rhy=True, fix_chd=False)
    want = np.asarray(jdv.swap(jp, JAX_TINY, jnp.asarray(pr),
                               jnp.asarray(pr[::-1]), jnp.asarray(c),
                               jnp.asarray(c[::-1]), True, False))
    np.testing.assert_array_equal(got, want)

    sd_pt, _ = _state_dict("pianotree", seed=4)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd_pt.items()},
               src)
    convert_checkpoint.main(["--from-torch", src, "--out", ck, "--device",
                             "cpu"], model_config=TINY)
    with pytest.raises(ValueError, match="detrended grid"):
        serve.main(["--checkpoint", ck, "--device", "cpu"])
