"""The port's data parallel (``pctd_tpu_torch/parallel``) against the JAX
package on the CPU at tiny width. Two ranks of a gloo process group
(``tests/torch_parallel_worker.py``, spawned once for the module) run the
data-parallel step on their rows of the seeded global batch of 16 that
``tests/test_parallel.py`` uses, on JAX-init weights through
``params_from_jax``, with zero latent noise and every teacher coin on: the
exact loss and gradients equal the JAX single-device loss and gradients
at the JAX package's own bars (``tests/test_parallel.py:96,129``), in both
loss modes, and the compat mode's loss is the mean of the halves' JAX
losses. The ranks' Trainers take the parallel train and eval steps on
their own rows and rank-seeded generators, stay identical, checkpoint
each rank's generator and resume bit for bit. At
world size 1 the collectives are identities: the loss with a group of one
rank, and the parallel step, equal the single-device path bit for bit.
``Sampler(mesh=)`` over two CPU devices decodes the plain Sampler's grids,
and the launcher's rehearsal gives every rank the single-process loss."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pctd_tpu.config import DataConfig as JDataConfig
from pctd_tpu.data.loaders import make_loaders as jmake_loaders
from pctd_tpu.data.synthetic import synthetic_corpora as jsynthetic_corpora
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.train.trainer import batch_features as jbatch_features
from pctd_tpu_torch.cli import launch_distributed
from pctd_tpu_torch.config import TrainConfig
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.parallel import Mesh, make_parallel_train_step
from pctd_tpu_torch.parallel import distributed as pdist
from pctd_tpu_torch.parallel import mesh as pm
from pctd_tpu_torch.train import checkpoint, schedules
from pctd_tpu_torch.train import trainer as tr
from pctd_tpu_torch.train.optim import Adam
from pctd_tpu_torch.utils.weights import named_leaves
from tests.torch_port_helpers import JAX_TINY, TINY, jax_params, \
    port_params, raw_segments, requests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16
WORLD = 2
TCFG = TrainConfig(batch_size=B, accum_steps=1)
BETA = schedules.train_params_at(0, TCFG)["beta"]
JOIN_TIMEOUT = 240


def global_batch():
    """The seeded global batch of ``tests/test_parallel.py:27-33``."""
    cfg = dataclasses.replace(JDataConfig(), portion=4)
    train, val = jsynthetic_corpora(n_songs=4, seed=2, n_bars=8, cfg=cfg)
    tl, _ = jmake_loaders(train, val, batch_size=B, seed=0)
    return next(tl.epoch())


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _join(procs, what):
    """Wait for every process (killing those still running after
    JOIN_TIMEOUT seconds); assert each exited 0."""
    try:
        outs = [p.communicate(timeout=JOIN_TIMEOUT)[0] for p in procs]
    finally:
        _stop(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what}: rc {p.returncode}\n{out}"
    return outs


class Ranks:
    """The two worker ranks, started at construction; :meth:`results`
    waits for them and loads what each wrote."""

    def __init__(self, d, jp, batch):
        self.d = d
        torch.save({"cfg": TINY, "batch": batch,
                    "params": {"params": {n: t for n, t in named_leaves(
                        port_params(jp)).items()}}}, d / "inputs.pt")
        port = pdist.free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(r),
             str(WORLD), str(port), str(d)], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            _join(self.procs, "worker")
            self._results = [torch.load(self.d / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(WORLD)]
        return self._results


@pytest.fixture(scope="module", autouse=True)
def case(tmp_path_factory):
    """The worker ranks and the launcher's rehearsal, started before the
    module's first test so that they run beside the in-process tests."""
    jp = jax_params(seed=1)
    batch = global_batch()
    ranks = Ranks(tmp_path_factory.mktemp("ranks"), jp, batch)
    rehearsal = subprocess.Popen(
        [sys.executable, "-m", "pctd_tpu_torch.cli.launch_distributed",
         "--rehearse", str(WORLD)], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield jp, batch, ranks, rehearsal
    finally:
        _stop(ranks.procs + [rehearsal])


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone."""
    pdist.initialize_local("gloo")
    try:
        yield pm.make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _loss_case(n=4, seed=3):
    pr, chord = raw_segments(n, seed=seed)
    shift = np.zeros(n, np.int32)
    x, c, pr_mat, _ = tr.batch_features(
        torch.from_numpy(pr), torch.from_numpy(chord),
        torch.from_numpy(shift), TINY)
    return pr, chord, shift, x, c, pr_mat


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "logits"])
def test_a_group_of_one_rank_is_the_identity(world_of_one, fused):
    """``group`` of one rank: the loss, its metrics and its gradients are
    the single-device ones bit for bit."""
    mesh = world_of_one
    cfg = dataclasses.replace(TINY, fused_loss=fused)
    pr, chord, shift, x, c, pr_mat = _loss_case()
    noise = tdv.draw_noise(torch.Generator().manual_seed(4), cfg, 4, 0.5,
                           0.5, 0.5)
    runs = []
    for group in (None, mesh.group):
        params = tdv.init_params(cfg, seed=2, device="cpu")
        leaves = tr.param_list(params)
        for t in leaves:
            t.requires_grad_(True)
        total, metrics = tdv.loss(params, cfg, x, c, pr_mat, noise,
                                  group=group)
        runs.append((tr.stacked(metrics).detach(),
                     torch.autograd.grad(total, leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_the_step_at_world_size_one_is_loss_and_grads_and_adam(
        world_of_one):
    """The parallel step over a group of one rank: the metrics, gradient
    norm and updated params of ``loss_and_grads`` + Adam, bit for bit."""
    mesh, cfg = world_of_one, TINY
    pr, chord, shift, x, c, pr_mat = _loss_case()
    tcfg = dataclasses.replace(TCFG, batch_size=4)
    after = []
    for parallel in (False, True):
        params = tdv.init_params(cfg, seed=2, device="cpu")
        leaves = tr.param_list(params)
        for t in leaves:
            t.requires_grad_(True)
        opt = Adam(leaves, tcfg)
        gen = torch.Generator().manual_seed(9)
        if parallel:
            step = make_parallel_train_step(cfg, tcfg, opt, mesh)
            m, norm = step(params, 0, gen, *(torch.from_numpy(a) for a in
                                             (pr, chord, shift)))
        else:
            metrics, grads = tr.loss_and_grads(
                params, cfg, tcfg, schedules.train_params_at(0, tcfg), gen,
                x, c, pr_mat)
            m, norm = tr.stacked(metrics), opt.step(grads)
        after.append((m, norm, [t.detach().clone() for t in leaves]))
    assert torch.equal(after[0][0], after[1][0])
    assert torch.equal(after[0][1], after[1][1])
    assert all(torch.equal(a, b) for a, b in zip(after[0][2], after[1][2]))


def test_the_step_refuses_gradient_accumulation():
    mesh = Mesh((torch.device("cpu"),))
    opt = Adam([], TCFG)
    with pytest.raises(ValueError, match="no gradient accumulation"):
        make_parallel_train_step(TINY, dataclasses.replace(
            TCFG, accum_steps=2), opt, mesh)
    with pytest.raises(ValueError, match="does not split"):
        pm.batch_rows(Mesh((torch.device("cpu"),) * 2, None, 1, 3), 16)


def test_rank_seeds_are_distinct_and_rank_zero_keeps_the_seed():
    seeds = [pm.rank_seed(3345, r) for r in range(64)]
    assert seeds[0] == 3345 and len(set(seeds)) == 64


def test_sampler_over_two_devices_decodes_the_plain_grids():
    params = port_params(jax_params(seed=0))
    mesh = Mesh((torch.device("cpu"),) * 2)
    pr, c = requests(9, 5)
    for fb, n in ((4, 9), (None, 8)):
        plain = Sampler(params, TINY, fixed_batch=fb, device="cpu")
        split = Sampler(params, TINY, fixed_batch=fb, mesh=mesh)
        want = plain.swap(pr[:n], pr[:n][::-1].copy(), c[:n],
                          c[:n][::-1].copy(), True, False)
        got = split.swap(pr[:n], pr[:n][::-1].copy(), c[:n],
                         c[:n][::-1].copy(), True, False)
        np.testing.assert_array_equal(got, want)
        assert (want[..., 0] < 128).any()   # notes, not only eos
    with pytest.raises(ValueError, match="not divisible"):
        Sampler(params, TINY, fixed_batch=3, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        Sampler(params, TINY, mesh=mesh).swap(pr, pr, c, c, True, False)


def test_distributed_helpers_at_world_size_one(world_of_one, monkeypatch):
    """``initialize`` names its backend, is a no-op at one process and
    refuses a half-given address; the world group's mesh (the JAX global
    and hybrid meshes), a rank's rows and the broadcast of rank 0's params
    at world size 1."""
    with pytest.raises(ValueError, match="name the backend"):
        pdist.initialize(num_processes=2, process_id=0)
    assert pdist.initialize(num_processes=1, backend="gloo") is False
    with pytest.raises(ValueError, match="needs num_processes"):
        pdist.initialize("localhost:1", backend="gloo")
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "RANK": "0",
           "WORLD_SIZE": "2"}
    for k in env:
        monkeypatch.delenv(k, raising=False)
    assert not pdist.under_torchrun()
    with pytest.raises(ValueError, match="run under torchrun"):
        pdist.initialize(backend="gloo")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pdist.under_torchrun()
    mesh = world_of_one
    assert (mesh.devices, mesh.rank, mesh.world) == (
        (torch.device("cpu"),), 0, 1)
    assert mesh.group is dist.group.WORLD
    assert pm.batch_rows(mesh, 16) == slice(0, 16)
    params = tdv.init_params(TINY, seed=0, device="cpu")
    before = [t.clone() for t in tr.param_list(params)]
    assert pm.replicate(mesh, params) is params
    assert all(torch.equal(a, b) for a, b in
               zip(before, tr.param_list(params)))
    pr = np.arange(12).reshape(4, 3)
    assert torch.equal(pm.shard_batch(mesh, pr), torch.as_tensor(pr))
    assert torch.equal(pm.shard_batch(Mesh((torch.device("cpu"),) * 2,
                                           None, 1, 2), pr),
                       torch.as_tensor(pr[2:]))


@pytest.fixture(scope="module")
def jax_reference(case):
    """The JAX single-device loss, metrics and gradients on the global
    batch (XLA path, posterior means, teacher-forcing rate 1, the port
    step's beta at step 0), and the totals of its two halves."""
    jp, batch, _, _ = case
    cfg = dataclasses.replace(JAX_TINY, train_frame_kernel=False)
    x, c, pr_mat, _ = jbatch_features(*(jnp.asarray(batch[k]) for k in
                                        ("pr", "chord", "shift")), cfg)
    key = jax.random.PRNGKey(0)

    def det(p, x, c, pr_mat):
        return jdv.loss(p, cfg, key, x, c, pr_mat, tfr1=1.0, tfr2=1.0,
                        tfr3=1.0, beta=BETA, weights=TCFG.weights,
                        weighted_dur=TCFG.weighted_dur, sample=False)

    (total, metrics), grads = jax.jit(jax.value_and_grad(
        det, has_aux=True))(jp, x, c, pr_mat)
    half = jax.jit(lambda p, x, c, m: det(p, x, c, m)[0])
    h = B // WORLD
    halves = [float(half(jp, x[i * h:(i + 1) * h], c[i * h:(i + 1) * h],
                         pr_mat[i * h:(i + 1) * h])) for i in range(WORLD)]
    flat = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    return ({k: float(v) for k, v in metrics.items()}, float(total), flat,
            halves)


def _metrics(m):
    return dict(zip(tdv.METRIC_NAMES, m.tolist()))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "logits"])
def test_exact_loss_equals_jax_single_device(case, jax_reference, fused):
    jmetrics, jtotal, _, _ = jax_reference
    got = [r["loss"][(fused, True)]["metrics"] for r in case[2].results()]
    assert torch.equal(got[0], got[1])
    port = _metrics(got[0])
    np.testing.assert_allclose(port["loss"], jtotal, rtol=1e-5)
    for k in tdv.METRIC_NAMES:
        np.testing.assert_allclose(port[k], jmetrics[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "logits"])
def test_exact_gradients_equal_jax_single_device(case, jax_reference,
                                                 fused):
    _, _, jgrads, _ = jax_reference
    got = [r["loss"][(fused, True)]["grads"] for r in case[2].results()]
    assert sorted(got[0]) == sorted(jgrads)
    for name, g in got[0].items():
        assert torch.equal(g, got[1][name])
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=2e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "logits"])
def test_compat_loss_is_the_mean_of_the_halves(case, jax_reference, fused):
    halves = jax_reference[3]
    got = [r["loss"][(fused, False)]["metrics"] for r in case[2].results()]
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0][0].item(), np.mean(halves),
                               rtol=1e-5)
    # the per-replica means differ from the global mean
    assert got[0][0].item() != case[2].results()[0]["loss"][
        (fused, True)]["metrics"][0].item()


def test_trainer_ranks_keep_identical_params(case):
    r0, r1 = (r["trainer"] for r in case[2].results())
    for step in ("params3", "params4"):
        for a, b in zip(r0[step], r1[step]):
            assert torch.equal(a, b)
    assert r0["history"] == r1["history"]
    assert r0["val"] == r1["val"] and np.isfinite(r0["val"]["loss"])
    assert all(np.isfinite(list(m.values())).all() for m in r0["history"])
    # the run trains: the params moved
    first = checkpoint.params_of({"params": {n: t for n, t in named_leaves(
        port_params(case[0])).items()}}, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(
        tr.param_list(first), r0["params4"]))


def test_trainer_steps_are_the_parallel_steps_on_the_rank_rows(case):
    """Each rank's Trainer step 1 is ``make_parallel_train_step`` on its
    ``shard_batch`` rows with a generator seeded by ``rank_seed(seed,
    rank)``, and its eval epoch ``make_parallel_eval_step`` on its rows of
    the val batch, bit for bit (whole batches, or one generator for both
    ranks, would draw other noise)."""
    for r in case[2].results():
        t = r["trainer"]
        ref = t["step1_reference"]
        assert t["history"][0] == ref["metrics"]
        for a, b in zip(t["params1"], ref["params"], strict=True):
            assert torch.equal(a, b)
        assert t["val"] == t["val_reference"]


def test_checkpoint_holds_each_ranks_generator(case):
    """The checkpoint rank 0 wrote holds both ranks' generator states, in
    rank order, and they differ."""
    saved = checkpoint.load_state(str(case[2].d / "run" / "models" /
                                      "disvae_half"))
    states = [r["trainer"]["gen_at_half"] for r in case[2].results()]
    assert len(saved["generators"]) == WORLD
    for got, want in zip(saved["generators"], states):
        assert torch.equal(got, want)
    assert not torch.equal(states[0], states[1])


def test_resume_equals_the_unbroken_run(case):
    for r in case[2].results():
        t = r["trainer"]
        assert t["resumed_step"] == 4
        assert t["resumed_history"] == t["history"][2:]
        for a, b in zip(t["resumed_params"], t["params4"]):
            assert torch.equal(a, b)


def test_resume_at_another_world_size_raises(tmp_path):
    params = tdv.init_params(TINY, seed=0, device="cpu")
    opt = Adam(tr.param_list(params), TCFG)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    two = str(tmp_path / "two")
    checkpoint.save_state(two, params, opt, 3, gens[0], TINY,
                          [g.get_state() for g in gens])
    one = str(tmp_path / "one")
    checkpoint.save_state(one, params, opt, 3, gens[0], TINY)
    g = torch.Generator()
    with pytest.raises(ValueError, match="2 rank"):
        checkpoint.restore_state(two, params, opt, g)
    with pytest.raises(ValueError, match="1 rank"):
        checkpoint.restore_state(one, params, opt, g, rank=1, world=2)
    assert checkpoint.restore_state(two, params, opt, g, rank=1,
                                    world=2) == 3
    assert torch.equal(g.get_state(), gens[1].get_state())


def test_launcher_rehearsal_gives_every_rank_the_single_process_loss(case):
    out, = _join([case[3]], "rehearsal")
    losses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"REHEARSAL_OK rank=(\d+) world=2 loss=(\S+)", out)}
    assert sorted(losses) == [0, 1] and losses[0] == losses[1], out
    assert "rcs=[0, 0]" in out
    single = launch_distributed.rehearsal_step(
        Mesh((torch.device("cpu"),)))
    np.testing.assert_allclose(losses[0], single, rtol=1e-5)

