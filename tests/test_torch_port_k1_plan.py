"""K1's plan (``build.k1_plan``) and its weight panels
(``train_frame.pack_panels``): pure Python, runs on the CPU. The plan takes
row groups of 16 rows, one cluster of 8 or 16 blocks each, or the per-row
kernel at 1, 2 or 4 rows a block, whichever has the least waves x measured
wave time; the panels hold every block's columns of the chain products
k-major, a pure layout change of the weights."""
import pytest
import torch

from pctd_tpu_torch.config import ModelConfig, tiny_model_config
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.ops.kernels import build
from pctd_tpu_torch.ops.kernels import train_frame as tf

#: clusters at once that the row-group kernels report on an H100 SXM (132
#: SMs): one block an SM, and a cluster's blocks share a GPC, so 7 clusters
#: of 16 fit, not 132 // 16 = 8
H100 = {16: 7, 8: 15}


def _check(plan, batch, sms, at_once, wave_ms):
    """The plan is the cheapest of every candidate, its waves counted."""
    cdiv = lambda a, b: -(-a // b)
    groups = cdiv(batch, 16)
    costs = [cdiv(groups, at_once[c]) * wave_ms[("group", c)]
             for c in (8, 16) if at_once.get(c, 0) > 0]
    costs += [cdiv(cdiv(batch, r), sms) * wave_ms[("rows", r)]
              for r in (1, 2, 4)]
    assert plan.ms == pytest.approx(min(costs))
    if plan.C:
        assert plan.R == 0 and plan.units == groups
        assert plan.waves == cdiv(groups, at_once[plan.C])
    else:
        assert plan.R in (1, 2, 4) and plan.units == cdiv(batch, plan.R)
        assert plan.waves == cdiv(plan.units, sms)


@pytest.mark.parametrize("batch,C,R,waves", [(1, 16, 0, 1), (16, 16, 0, 1),
                                             (17, 16, 0, 1), (128, 8, 0, 1),
                                             (240, 8, 0, 1), (512, 0, 4, 1)])
def test_k1_plan_on_the_h100(batch, C, R, waves):
    """With the measured wave times: one cluster of 16 a group up to 7
    groups, 8 blocks a cluster while every group fits in one wave (up to
    240 rows), and the per-row kernel at 4 rows a block where the groups
    would take three waves (512 rows: one wave of 128 blocks)."""
    plan = build.k1_plan(batch, 132, H100)
    _check(plan, batch, 132, H100, build.K1_WAVE_MS)
    assert (plan.C, plan.R, plan.waves) == (C, R, waves)


def test_k1_plan_takes_the_row_groups_on_a_tie():
    """Equal wave times: row groups before the per-row kernel, then the
    larger cluster."""
    flat = {k: 1.0 for k in build.K1_WAVE_MS}
    assert build.k1_plan(16, 132, H100, flat)[:2] == (16, 0)
    assert build.k1_plan(128, 132, H100, flat)[:2] == (8, 0)


@pytest.mark.parametrize("batch", [1, 16, 17, 128, 240, 512])
def test_k1_plan_on_a_card_with_fewer_clusters(batch):
    """A card that holds no cluster of 16 and 2 of 8 (16 SMs): never 16
    blocks a cluster; the per-row kernel where the groups' waves cost
    more."""
    at_once = {16: 0, 8: 2}
    plan = build.k1_plan(batch, 16, at_once)
    _check(plan, batch, 16, at_once, build.K1_WAVE_MS)
    assert plan.C != 16


def test_k1_plan_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        build.k1_plan(0, 132)
    # no cluster fits: the per-row kernel
    assert build.k1_plan(16, 132, {16: 0, 8: 0}).C == 0


def _weights(width, dtype):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    params = dv.init_params(cfg, seed=0, device="cpu")
    cw = tf.CoreWeights(*(w.detach().to(dtype)
                          for w in tf.core_weights(params["dec"], cfg)))
    return cw, tf.dims_of(cw, cfg.pianotree)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("width", ["tiny", "canonical"])
def test_panels_give_back_every_weight_bit_for_bit(width, C, dtype):
    cw, d = _weights(width, dtype)
    buf = tf.pack_panels(cw, d, C)
    lay = tf.panel_layout(d, C, dtype)
    assert buf.dtype == dtype and buf.numel() == lay.size
    # every section starts 128 bytes aligned (the kernel's bulk copies)
    for off in lay[:-1]:
        assert off * buf.element_size() % 128 == 0
    back = tf.unpack_panels(buf, d, C)
    for f in tf.PANEL_FIELDS:
        assert torch.equal(_bits(back[f]), _bits(getattr(cw, f))), f


def test_panels_hold_each_block_its_columns_k_major():
    """Block c's hidden panel starts with its pitch columns, then its
    dur-hidden columns, then its three gates' w_hh columns, one k a row."""
    cw, d = _weights("canonical", torch.float32)
    C, c = 8, 3
    buf = tf.pack_panels(cw, d, C)
    lay = tf.panel_layout(d, C, torch.float32)
    s = tf.k1_share(d, C, c)
    n2 = s.Pc + s.Dc + 3 * s.U
    h = buf[c * lay.pstride + lay.o_h:][:d.NH * n2].view(d.NH, n2)
    assert torch.equal(h[:, :s.Pc], cw.w_pitch[:, s.p0:s.p0 + s.Pc])
    assert torch.equal(h[:, s.Pc:s.Pc + s.Dc],
                       cw.w_dhid[:d.NH, s.d0:s.d0 + s.Dc])
    for g in range(3):
        cols = slice(g * d.NH + s.j0, g * d.NH + s.j0 + s.U)
        at = s.Pc + s.Dc + g * s.U
        assert torch.equal(h[:, at:at + s.U], cw.w_hh[:, cols])


@pytest.mark.parametrize("bad", ["NH", "EH"])
def test_panels_refuse_a_width_that_is_not_whole_quads(bad):
    _, d = _weights("tiny", torch.float32)
    d = d._replace(**{bad: getattr(d, bad) + 2})
    with pytest.raises(ValueError, match=f"{bad} % 4"):
        tf.panel_layout(d, 8, torch.float32)
    with pytest.raises(ValueError, match="clusters"):
        tf.panel_layout(d._replace(**{bad: getattr(d, bad) - 2}), 4,
                        torch.float32)


def test_panels_are_packed_once_while_the_weights_stay():
    cw, d = _weights("tiny", torch.float32)
    before = tf.panels.packs
    a = tf.panels(cw, d, 8)
    assert tf.panels(cw, d, 8) is a and tf.panels.packs == before + 1
    with torch.no_grad():
        cw.w_hh.add_(1.0)            # an optimizer step: the version moves
    b = tf.panels(cw, d, 8)
    assert tf.panels.packs == before + 2 and b is not a
    assert torch.equal(tf.unpack_panels(b, d, 8)["w_hh"], cw.w_hh)
    fresh = tf.CoreWeights(*(w.clone() for w in cw))   # new tensors
    tf.panels(fresh, d, 8)
    assert tf.panels.packs == before + 3
