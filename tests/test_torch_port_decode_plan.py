"""The plan of the row-group decode kernels K3/K4 (``build.decode_plan``):
groups of 16 rows, one cluster of 16 blocks each where every group fits on
the card at once, else 8, and the waves that the clusters the card holds
at once take; and how a request's fixed-batch chunks share K4 launches
(``full_decoder.launch_runs``). Pure Python: runs on the CPU."""
import pytest

from pctd_tpu_torch.ops.kernels import build, full_decoder

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


@pytest.mark.parametrize("chunks,rows,cap,runs", [
    (1, 16, 7, [1]),              # one chunk: its own launch, as before
    (7, 16, 7, [7]),              # exactly the cap
    (8, 16, 7, [7, 1]),           # one past it: a second launch
    (5, 24, 7, [3, 2]),           # 24 rows take 2 groups: 3 a launch
    (4, 8, H100[16], [4]),        # 8 rows take a whole group
    (3, 128, H100[16], [1, 1, 1]),  # wider than the cap: one a launch
    (9, 16, None, [9]),           # no cap (the CPU): one launch
])
def test_chunks_share_k4_launches_up_to_the_cap(chunks, rows, cap, runs):
    got = full_decoder.launch_runs(chunks, rows, cap)
    assert got == runs and sum(got) == chunks
    groups = -(-rows // 16)
    for n in got:
        # within one wave of 16-block clusters, unless a chunk alone is not
        assert cap is None or n * groups <= cap or n == 1
        # every launch a plan of 16 blocks a cluster where the chunks fit
        if cap is not None and n * groups <= cap:
            assert build.decode_plan(n * groups * 16, 132,
                                     {16: cap, 8: 2 * cap}).C == 16
