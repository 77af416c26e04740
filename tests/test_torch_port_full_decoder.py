"""The port's whole-sequence decode against the JAX package on the same
weights (CPU): K4's plain version against the Pallas full-decode kernel in
interpret mode and the XLA nested-scan decode, the port's decode paths
against each other, and one canonical-width decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pctd_tpu import config as jcfg
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu.ops.pallas.full_decoder import decode_grid_fused
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import pianotree_decoder as tptd
from pctd_tpu_torch.ops.kernels import ar_decoder, full_decoder

from tests.torch_port_helpers import (JAX_TINY, TINY, eos_biased,
                                      jax_params, port_params, t)

SPEC = TINY.pianotree


def _frame_lengths(grid):
    """(B, T, K-1, 6) grid -> (B, T) slots before the first eos (15 when
    none), the decode's frame lengths."""
    eos = grid[..., 0] == SPEC.pitch_eos
    return np.where(eos.any(-1), eos.argmax(-1) + 1, SPEC.max_simu_note - 1)


def _port_grid(jp, z, frame_decoder="full"):
    return tptd.decode_grid(port_params(jp)["dec"], TINY, t(z),
                            frame_decoder).numpy()


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_full_decode_plain_matches_fused_kernel_and_xla(weights):
    jp = jax_params(seed=0)
    z = np.random.RandomState(2).randn(4, TINY.z_dim).astype(np.float32)
    if weights == "eos_biased":
        jp = eos_biased(jp, 0.6, lambda q: _frame_lengths(_port_grid(q, z)))
    tp = port_params(jp)
    fw = ar_decoder.folded_frame_weights(tp["dec"], TINY)
    inputs = tptd.decode_inputs(tp["dec"], TINY, t(z))
    got = full_decoder.decode_grid_full_plain(fw, SPEC, *inputs).numpy()
    fused = np.asarray(decode_grid_fused(jp["dec"], JAX_TINY, jnp.asarray(z),
                                         interpret=True))
    xla = np.asarray(jptd.decode_grid(jp["dec"], JAX_TINY, jnp.asarray(z),
                                      frame_decoder="xla"))
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, xla)


def test_port_decode_paths_agree_and_logits_match_jax():
    """decode_grid through K4's and K3's plain versions equals the port's
    nested-loop decode, whose logits match the JAX fold_heads decode."""
    jp = jax_params(seed=2)
    tp = port_params(jp)
    z = np.random.RandomState(3).randn(3, TINY.z_dim).astype(np.float32)
    out = tptd.decode(tp["dec"], TINY, t(z))
    grid = tptd.output_to_grid(out).numpy()
    np.testing.assert_array_equal(_port_grid(jp, z, "full"), grid)
    np.testing.assert_array_equal(_port_grid(jp, z, "frame"), grid)
    with jax.default_matmul_precision("highest"):
        want = jptd.decode(jp["dec"], JAX_TINY, jnp.asarray(z),
                           fold_heads=True)
    np.testing.assert_array_equal(grid,
                                  np.asarray(jptd.output_to_grid(want)))
    np.testing.assert_allclose(out.pitch_logits.numpy(),
                               np.asarray(want.pitch_logits), atol=1e-5)
    np.testing.assert_allclose(out.dur_logits.numpy(),
                               np.asarray(want.dur_logits), atol=1e-5)
    with pytest.raises(ValueError):
        tptd.decode_grid(tp["dec"], TINY, t(z), "xla")


def test_canonical_width_decode_z_matches_jax():
    """Canonical widths (time GRU 1024, notes 512, dur 64), B=2: the
    decoded grids agree with the JAX XLA decode on >= 0.999 of cells."""
    cfg_j = jcfg.ModelConfig()
    cfg_t = tcfg.ModelConfig()
    jp = jax_params(cfg_j, seed=4)
    rng = np.random.RandomState(5)
    zc = (rng.randn(2, cfg_j.chd_z_dim) * 0.5).astype(np.float32)
    zr = (rng.randn(2, cfg_j.txt_z_dim) * 0.5).astype(np.float32)
    want = np.asarray(jdv.decode_z(jp, cfg_j, jnp.asarray(zc),
                                   jnp.asarray(zr)))
    got = tdv.decode_z(port_params(jp), cfg_t, t(zc), t(zr)).numpy()
    assert got.shape == want.shape == (2, 32, 15, 6)
    assert got.dtype == np.int32
    assert (got == want).mean() >= 0.999
