"""K3's plain version (the port's one-frame decode) against the JAX
package's Pallas frame kernel in interpret mode, on the same weights and
inputs (CPU, tiny dims)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu.ops.pallas.ar_decoder import frame_decode_pallas
from pctd_tpu_torch.models import pianotree_decoder as tptd
from pctd_tpu_torch.ops.kernels import ar_decoder, full_decoder

from tests.torch_port_helpers import (JAX_TINY, TINY, eos_biased,
                                      jax_params, port_params, t)

SPEC = TINY.pianotree


def _frame_inputs(jp, B=8, seed=1):
    rng = np.random.RandomState(seed)
    h = (rng.randn(B, TINY.dec_time_hidden) * 0.6).astype(np.float32)
    sos = np.asarray(jptd.dense_apply(jp["dec"]["note_emb"],
                                      jptd.sos_token_raw(JAX_TINY.pianotree)))
    return h, np.ascontiguousarray(np.broadcast_to(sos, (B, sos.shape[-1])))


def _port_frame(jp, h, sos):
    fw = ar_decoder.folded_frame_weights(port_params(jp)["dec"], TINY)
    return ar_decoder.frame_decode_plain(fw, SPEC, t(h), t(sos))


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_frame_decode_plain_matches_pallas_frame_kernel(weights):
    jp = jax_params(seed=0)
    h, sos = _frame_inputs(jp)
    if weights == "eos_biased":
        jp = eos_biased(jp, 0.8,
                        lambda q: _port_frame(q, h, sos)[3].numpy())
    pitch, bits, summary, lengths = _port_frame(jp, h, sos)
    k_pitch, k_bits, k_summary, k_len = frame_decode_pallas(
        jp["dec"], JAX_TINY, jnp.asarray(h), jnp.asarray(sos),
        interpret=True)
    np.testing.assert_array_equal(pitch.numpy(), np.asarray(k_pitch))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(k_bits))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(k_len))
    np.testing.assert_allclose(summary.numpy(), np.asarray(k_summary),
                               atol=2e-5)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    jp = jax_params(seed=0)
    h, sos = _frame_inputs(jp, B=2)
    before = (ar_decoder.frame_decode.launches,
              full_decoder.decode_grid_full.launches)
    fw = ar_decoder.folded_frame_weights(port_params(jp)["dec"], TINY)
    got = ar_decoder.frame_decode(fw, SPEC, t(h), t(sos))
    want = ar_decoder.frame_decode_plain(fw, SPEC, t(h), t(sos))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    z = np.random.RandomState(0).randn(2, TINY.z_dim).astype(np.float32)
    tptd.decode_grid(port_params(jp)["dec"], TINY, t(z))
    assert (ar_decoder.frame_decode.launches,
            full_decoder.decode_grid_full.launches) == before




@pytest.mark.parametrize("batch,rows", [(1, 1), (128, 1), (256, 2),
                                        (300, 4), (512, 4)])
def test_rows_per_block_fills_the_card_in_fewest_waves(batch, rows):
    """Serving chunks of 128 rows take one row a block (128 blocks on 132
    SMs); larger batches trade slower blocks for fewer waves."""
    from pctd_tpu_torch.ops.kernels.build import rows_per_block

    assert rows_per_block(batch, sms=132) == rows


def test_ctypes_struct_matches_the_cuda_struct():
    """build.DecoderWeightsC must list DecoderWeights' fields of
    csrc/decoder.cu in the same order, or the kernels read the wrong
    weights."""
    import re

    from pctd_tpu_torch.ops.kernels import build

    src = (build.CSRC / "decoder.cu").read_text()
    body = re.search(r"struct DecoderWeights \{(.*?)\};", src, re.S).group(1)
    ptrs, ints = body.split(";")[:2]
    c_ptrs = re.findall(r"\*(\w+)", ptrs)
    c_ints = [n.strip() for n in ints.replace("int ", "").split(",")]
    assert c_ptrs == list(ar_decoder.FoldedWeights._fields)
    assert c_ints == list(build.Dims._fields)
    assert [f for f, _ in build.DecoderWeightsC._fields_] == c_ptrs + c_ints


def test_kernel_input_checks_refuse_cpu_tensors():
    from pctd_tpu_torch.ops.kernels import build

    fw = ar_decoder.folded_frame_weights(port_params(jax_params())["dec"],
                                         TINY)
    h = torch.zeros(2, TINY.dec_time_hidden)
    with pytest.raises(ValueError, match="CUDA"):
        build.check_inputs(fw, torch.device("cpu"), [("h", h, (2, 16))])
