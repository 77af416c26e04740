"""The plan of the row-group decode kernels K3/K4 (``build.decode_plan``):
groups of 16 rows, one cluster of 16 blocks each where every group fits on
the card at once, else 8, and the waves that the clusters the card holds
at once take. Pure Python: runs on the CPU."""
import pytest

from pctd_tpu_torch.ops.kernels import build

#: clusters at once that the row-group K3 reports on an H100 SXM (132 SMs):
#: its shared memory gives one block an SM, and a cluster's blocks share a
#: GPC, so 7 clusters of 16 fit, not 132 // 16 = 8
H100 = {16: 7, 8: 15}


def _check(plan, batch, at_once):
    assert plan.G == build.DECODE_G == 16
    assert plan.groups == -(-batch // 16)
    assert plan.C in build.DECODE_CLUSTERS and at_once[plan.C] > 0
    # every group gets a cluster, in as few waves as the card allows
    assert plan.waves == -(-plan.groups // at_once[plan.C])
    assert (plan.waves - 1) * at_once[plan.C] < plan.groups \
        <= plan.waves * at_once[plan.C]
    # 16 blocks exactly when every group fits at once
    assert (plan.C == 16) == (0 < plan.groups <= at_once[16])


@pytest.mark.parametrize("batch,C,waves", [(1, 16, 1), (37, 16, 1),
                                           (128, 16, 1), (300, 8, 2),
                                           (512, 8, 2)])
def test_plan_on_132_sms_from_the_sm_count(batch, C, waves):
    plan = build.decode_plan(batch, 132)
    _check(plan, batch, {c: 132 // c for c in build.DECODE_CLUSTERS})
    assert (plan.C, plan.waves) == (C, waves)


@pytest.mark.parametrize("batch,C,waves", [(1, 16, 1), (37, 16, 1),
                                           (128, 8, 1), (300, 8, 2),
                                           (512, 8, 3)])
def test_plan_on_the_h100_occupancy(batch, C, waves):
    plan = build.decode_plan(batch, 132, H100)
    _check(plan, batch, H100)
    assert (plan.C, plan.waves) == (C, waves)


@pytest.mark.parametrize("batch", [1, 37, 128, 300, 512])
@pytest.mark.parametrize("sms", [8, 12, 16, 20])
def test_plan_on_a_small_card(batch, sms):
    """Few SMs: one cluster of 16 fits at most; 8 takes over as soon as
    more than one group must wait, and the waves grow with the batch."""
    at_once = {c: sms // c for c in build.DECODE_CLUSTERS}
    plan = build.decode_plan(batch, sms)
    _check(plan, batch, at_once)
    if sms < 16:
        assert plan.C == 8
    assert plan.waves == -(-plan.groups // at_once[plan.C])


def test_plan_refuses_an_empty_batch_and_a_card_too_small():
    with pytest.raises(ValueError):
        build.decode_plan(0, 132)
    with pytest.raises(RuntimeError, match="no cluster size"):
        build.decode_plan(16, 7)           # not one cluster of 8 fits
    with pytest.raises(RuntimeError, match="no cluster size"):
        build.decode_plan(16, 132, {16: 0, 8: 0})


def test_plan_never_takes_a_size_that_does_not_fit():
    """A card that reports no cluster of 16 at once (the size refused)
    decodes every batch in clusters of 8."""
    for batch in (1, 37, 128, 300, 512):
        plan = build.decode_plan(batch, 132, {16: 0, 8: 15})
        assert plan.C == 8 and plan.waves == -(-plan.groups // 15)
