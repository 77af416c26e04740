"""The port's serving daemon, generate and arrange CLIs against the JAX
package on the CPU at tiny widths, weights from the JAX init through
``params_from_jax`` (eos-biased, so frames end at varied lengths): the MIDI
they write is byte-equal to the JAX package's where no noise is drawn, a
seeded request gives the bytes of the port's Sampler called with a
generator of that seed, and ``reload`` serves the new weights (folded
again) or, for a checkpoint of other widths, changes nothing."""
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.data import converter as jconv
from pctd_tpu.data import demo as jdemo
from pctd_tpu.data import songs as jsongs
from pctd_tpu.data import tensorize as jtz
from pctd_tpu.data.corpus import song_to_segments as jsong_to_segments
from pctd_tpu.data.ingest import ingest_directory as jingest_directory
from pctd_tpu.data.ingest import midi_to_musics as jmidi_to_musics
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models.sampler import Sampler as JSampler
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.cli import arrange, generate, serve, train
from pctd_tpu_torch.config import TrainConfig
from pctd_tpu_torch.data import demo as tdemo
from pctd_tpu_torch.data.midi_io import MidiFile
from pctd_tpu_torch.data.songs import midi_to_windows
from pctd_tpu_torch.data.synthetic import synthetic_song
from pctd_tpu_torch.data.tensorize import tensorize_batch
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.parallel import Mesh
from pctd_tpu_torch.train import checkpoint
from pctd_tpu_torch.train.optim import Adam
from pctd_tpu_torch.train.trainer import param_list
from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, with_eos_bias)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = TINY.pianotree
EOS_BIAS = 0.6


def _jax_serve_module():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_script", os.path.join(ROOT, "scripts", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_song(path, seed, n_bars, names=("melody", "bridge", "piano")):
    music = synthetic_song(np.random.RandomState(seed), n_bars=n_bars)
    music.track_name_list = list(names)
    music.write_midi(path)
    return path


def save_checkpoint(path, params, cfg=TINY):
    """A port train checkpoint of ``params`` (the train CLI's format)."""
    checkpoint.save_state(path, params, Adam(param_list(params),
                                             TrainConfig()), 0,
                          torch.Generator(), cfg)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    jp = with_eos_bias(jax_params(JAX_TINY, seed=0), EOS_BIAS)
    files = {"a": write_song(str(d / "a.mid"), 0, 10),
             "b": write_song(str(d / "b.mid"), 1, 14),
             "c": write_song(str(d / "c.mid"), 2, 8)}
    return d, jp, files


@pytest.fixture(scope="module")
def servers(world):
    """(the JAX daemon's ``Server`` from ``scripts/serve.py`` on the XLA
    route, the port's ``Server`` on the CPU), both at fixed batch 4 on the
    world's weights, built once: neither changes its weights here."""
    _, jp, _ = world
    js = _jax_serve_module()
    jserver = js.Server(JSampler(jp, JAX_TINY, frame_decoder="xla",
                                 fixed_batch=4), JAX_TINY.pianotree, 64,
                        cfg=JAX_TINY)
    return jserver, port_server(port_params(jp))


def port_server(params, fixed_batch=4):
    return serve.Server(Sampler(params, TINY, fixed_batch=fixed_batch,
                                device="cpu"), SPEC, 64, cfg=TINY)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


REQUESTS = [
    {"op": "style_transfer", "content": "a", "style": "b", "fix": "chord"},
    {"op": "style_transfer", "content": "b", "style": "c",
     "fix": "texture"},
    {"op": "interp", "a": "a", "b": "c", "count": 3, "what": "chord"},
    {"op": "interp", "a": "b", "b": "a", "count": 2, "what": "both"},
]


@pytest.mark.parametrize("req", REQUESTS, ids=lambda r: f"{r['op']}-"
                         f"{r.get('fix', r.get('what'))}")
def test_deterministic_ops_write_jax_bytes(world, servers, req):
    d, _, files = world
    jserver, mine = servers
    req = {k: files.get(v, v) if k in ("content", "style", "a", "b") else v
           for k, v in req.items()}
    tag = f"{req['op']}_{req.get('fix', req.get('what'))}"
    want = jserver.handle(dict(req, out=str(d / f"j_{tag}_%d.mid")))
    got = mine.handle(dict(req, out=str(d / f"t_{tag}_%d.mid")))
    outs = lambda r: r["out"] if isinstance(r["out"], list) else [r["out"]]
    assert got["ok"] and want["ok"]
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    assert len(outs(got)) == len(outs(want)) == req.get("count", 1)
    for a, b in zip(outs(got), outs(want)):
        assert _bytes(a) == _bytes(b)
    notes = [len(t.notes) for f in outs(got)
             for t in MidiFile.read(f).tracks]
    full = got["windows"] * 32 * (SPEC.max_simu_note - 2)
    assert 0 < min(notes) and max(notes) < full   # frames of varied length


def _direct_bytes(path, sampler, workflow, fn, seed, **kw):
    """What the port's Sampler writes for ``fn`` called with a generator of
    ``seed``, composed from the library alone."""
    pr, _, chord, bpm = midi_to_windows(fn, 64)
    f = tensorize_batch(torch.from_numpy(pr), torch.from_numpy(chord),
                        torch.zeros(len(pr), dtype=torch.int32),
                        spec=SPEC, with_detrend=False)
    gen = torch.Generator().manual_seed(seed)
    est = getattr(sampler, workflow)(gen, f["pr_mat"], f["c"], **kw)
    segs = [tdemo.grid_to_pr_and_notes(g, bpm=bpm, spec=SPEC)[1]
            for g in est]
    tdemo.write_demo(path, [segs], ["generated"], bpm=bpm, shift_beat=8)
    return _bytes(path)


@pytest.mark.parametrize("op,kw,sampler_kw", [
    ("variation", {"scale": 0.5}, {"scale": 0.5}),
    ("variation", {}, {"scale": None}),
    ("prior", {"sample": "texture"}, {"sample_rhy": True}),
    ("prior", {"sample": "chord", "scale": 0.7},
     {"sample_chd": True, "scale": 0.7}),
    ("prior", {"sample": "both"}, {"sample_chd": True, "sample_rhy": True}),
])
def test_seeded_ops_follow_the_generator(world, servers, op, kw,
                                        sampler_kw):
    d, _, files = world
    server = servers[1]
    runs = {}
    for seed in (3, 4):
        out = str(d / f"{op}_s{seed}.mid")
        r = server.handle(dict(kw, op=op, input=files["c"], out=out,
                               seed=seed))
        assert r["ok"] and r["windows"] == 4
        runs[seed] = _bytes(out)
    workflow = "posterior_sample" if op == "variation" else "prior_sample"
    # the same seed gives the same bytes, composed from the library alone
    assert runs[3] == _direct_bytes(str(d / f"{op}_direct.mid"), server.s,
                                    workflow, files["c"], 3, **sampler_kw)
    assert runs[3] != runs[4]


def test_reload_serves_new_weights_and_refuses_other_widths(world):
    d, jp, files = world
    other = with_eos_bias(jax_params(JAX_TINY, seed=9), EOS_BIAS)
    ck = save_checkpoint(str(d / "ck_other"), port_params(other))
    wide = dataclasses.replace(TINY, dec_time_hidden=24)
    ck_wide = save_checkpoint(str(d / "ck_wide"), tdv.init_params(
        wide, seed=1, device="cpu"), wide)
    req = {"op": "style_transfer", "content": files["c"],
           "style": files["b"]}
    server = port_server(port_params(jp))
    fresh = port_server(checkpoint.params_of(checkpoint.load_state(ck),
                                             "cpu"))
    out = lambda name: str(d / f"reload_{name}.mid")
    assert server.handle(dict(req, out=out("before")))["ok"]
    fold = server.s.fw
    assert server.handle({"op": "reload", "checkpoint": ck}) == \
        {"ok": True, "reloaded": ck}
    assert server.s.fw is not fold          # folded again
    server.handle(dict(req, out=out("after")))
    fresh.handle(dict(req, out=out("fresh")))
    assert _bytes(out("after")) == _bytes(out("fresh"))
    assert _bytes(out("after")) != _bytes(out("before"))
    # a checkpoint of other widths: refused, nothing swapped
    params, fw = server.s.params, server.s.fw
    buf = io.StringIO()
    serve.serve_lines(server, [json.dumps({"op": "reload",
                                           "checkpoint": ck_wide})], buf)
    reply = json.loads(buf.getvalue())
    assert reply["ok"] is False and "do not match" in reply["error"]
    assert server.s.params is params and server.s.fw is fw
    server.handle(dict(req, out=out("after_refusal")))
    assert _bytes(out("after_refusal")) == _bytes(out("fresh"))


def test_sampler_load_params_checks_every_leaf(world):
    _, jp, _ = world
    s = Sampler(port_params(jp), TINY, device="cpu")
    bad = port_params(jp)
    bad["dec"]["pitch_out"]["b"] = bad["dec"]["pitch_out"]["b"].double()
    with pytest.raises(ValueError, match="do not match"):
        s.load_params(bad)
    missing = port_params(jp)
    del missing["chd_dec"]
    with pytest.raises(ValueError, match="do not match"):
        s.load_params(missing)


def test_daemon_subprocess_survives_malformed_lines(world):
    """The request sequence of the JAX daemon's end-to-end test, through
    ``python -m pctd_tpu_torch.cli.serve --tiny --device cpu``."""
    d, _, files = world
    ck = save_checkpoint(str(d / "ck_tiny"), tdv.init_params(
        TINY, seed=7, device="cpu"))
    out1, out2 = str(d / "sub_st.mid"), str(d / "sub_var.mid")
    reqs = [json.dumps(r) for r in [
        {"op": "ping"},
        {"op": "style_transfer", "content": files["a"],
         "style": files["b"], "out": out1, "fix": "chord"},
        {"op": "variation", "input": files["a"], "out": out2, "scale": 0.5,
         "seed": 1},
        {"op": "nonsense"}]]
    reqs += ["{not json}", "[1, 2, 3]"]
    reqs += [json.dumps(r) for r in [
        {"op": "reload", "checkpoint": ck},
        {"op": "reload", "checkpoint": str(d / "missing")},
        {"op": "variation", "input": files["a"], "out": out2, "scale": 0.5,
         "seed": 2},
        {"op": "stats"},
        {"op": "quit"}]]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "pctd_tpu_torch.cli.serve", "--tiny",
         "--device", "cpu", "--fixed-batch", "4", "--max-windows", "4"],
        input="\n".join(reqs) + "\n", env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert any(ln.get("ready") for ln in lines[:3])
    replies = [ln for ln in lines if "ok" in ln]
    assert replies[0]["ok"] is True                       # ping
    assert replies[1]["ok"] and replies[1]["windows"] == 4
    assert replies[2]["ok"]                               # variation
    assert replies[3]["ok"] is False and "unknown op" in replies[3]["error"]
    assert replies[4]["ok"] is False                      # {not json}
    assert replies[5]["ok"] is False                      # [1, 2, 3]
    assert replies[6]["ok"] and replies[6]["reloaded"] == ck
    assert replies[7]["ok"] is False                      # missing ckpt
    assert replies[8]["ok"]                               # serves post-reload
    stats = replies[9]
    assert stats["ok"] and stats["stats"]["variation"]["count"] == 2
    assert stats["stats"]["variation"]["p50_ms"] > 0
    assert stats["stats"]["reload"]["count"] == 2         # incl. the failure
    assert replies[10]["ok"] and replies[10].get("bye")   # quit
    for out in (out1, out2):
        MidiFile.read(out)


@pytest.mark.parametrize("flag,route", [("auto", "full"),
                                        ("pallas_full", "full"),
                                        ("pallas", "frame"), ("xla", None)])
def test_frame_decoder_flag_maps_to_a_kernel_route(flag, route):
    buf = io.StringIO()
    argv = ["--tiny", "--device", "cpu", "--frame-decoder", flag]
    if route is None:
        with pytest.raises(SystemExit, match="not a serving route"):
            serve.main(argv, stdin=io.StringIO(""), stdout=buf)
        return
    serve.main(argv, stdin=io.StringIO('{"op": "quit"}\n'), stdout=buf)
    ready = [json.loads(ln) for ln in buf.getvalue().splitlines()][1]
    assert ready == {"ready": True, "fixed_batch": 16, "device": "cpu",
                     "devices": 1, "frame_decoder": route}


def _jax_texture(jp, pr, chord):
    spec = JAX_TINY.pianotree
    n = len(pr)
    feats = jtz.tensorize_batch(jnp.asarray(pr), jnp.asarray(chord),
                                jnp.zeros(n, jnp.int32), spec=spec,
                                with_detrend=False)
    return jdv.encode(jp, JAX_TINY, feats["pr_mat"], feats["c"])[1]


@pytest.mark.parametrize("given_bars,cycle,chords", [
    (2, False, None), (4, True, "C-Am-F-G")])
def test_arrange_writes_jax_bytes(world, given_bars, cycle, chords):
    """``scripts/arrange.py``'s steps in JAX, against ``cli.arrange``."""
    d, jp, files = world
    spec = JAX_TINY.pianotree
    ck = save_checkpoint(str(d / "ck_arrange"), port_params(jp))
    pr, mel, chord, bpm = jsongs.midi_to_windows(files["b"])
    n_win = len(pr)
    if chords:
        from pctd_tpu.data.chords import (progression_to_chord_table,
                                          split_progression)
        chord = progression_to_chord_table(
            split_progression(chords), n_win * 8).reshape(n_win, 8, 14)
    c = jnp.asarray(jconv.batch_expand_chord(chord, np.zeros(n_win)))
    z_chd = jdv.encode_chord(jp, JAX_TINY, c).mean
    n_given = given_bars // 2
    z_given = np.asarray(_jax_texture(jp, pr[:n_given],
                                      chord[:n_given]).mean)
    idx = (np.arange(n_win) % n_given if cycle
           else np.minimum(np.arange(n_win), n_given - 1))
    grids = np.asarray(jdv.decode_z(jp, JAX_TINY, z_chd,
                                    jnp.asarray(z_given[idx])))
    acc = [jdemo.grid_to_pr_and_notes(g, bpm=bpm, spec=spec)[1]
           for g in grids]
    for i in range(n_given):
        dur = jconv.piano_roll_to_target(jconv.pr_to_onehot_pr(
            pr[i].astype(int)))
        acc[i] = jdemo.pr_matrix_to_notes(dur, bpm=bpm)
    mels = [jdemo.mel_pr_to_notes(m, bpm=bpm) for m in mel]
    want = str(d / "arr_jax.mid")
    jdemo.write_demo(want, [mels, acc], ["melody", "arranged_acc"], bpm=bpm,
                     shift_beat=8)
    got = str(d / "arr_port.mid")
    argv = [files["b"], "--out", got, "--checkpoint", ck, "--device", "cpu",
            "--given-bars", str(given_bars)]
    argv += (["--cycle-texture"] if cycle else []) + (
        ["--chords", chords] if chords else [])
    assert arrange.main(argv) == got
    assert _bytes(got) == _bytes(want)
    names = [t.name for t in MidiFile.read(got).tracks]
    assert names == ["melody", "arranged_acc"]


def test_generate_texture_from_writes_jax_bytes(world):
    """``scripts/generate.py``'s steps in JAX (one sample, a donor's
    texture: means only), against ``cli.generate --texture-from``."""
    d, jp, files = world
    from pctd_tpu.data.chords import (progression_to_chord_table,
                                      split_progression)

    spec = JAX_TINY.pianotree
    ck = save_checkpoint(str(d / "ck_generate"), port_params(jp))
    bars, bpm = 6, 80.0
    symbols = split_progression("Am D7 G")
    n_windows = bars // 2
    total = n_windows * 8
    table = progression_to_chord_table(symbols, total,
                                       max(1, total // len(symbols)))
    c = jnp.asarray(jconv.batch_expand_chord(table.reshape(n_windows, 8, 14),
                                             np.zeros(n_windows)))
    z_chd = jdv.encode_chord(jp, JAX_TINY, c).mean
    seg = jsong_to_segments(jmidi_to_musics(files["b"],
                                            split_tracks=False)[0], 0)
    idx = np.linspace(0, len(seg) - 1, n_windows).astype(int)
    z_rhy = _jax_texture(jp, seg.pr[idx], seg.chord[idx]).mean
    grids = np.asarray(jdv.decode_z(jp, JAX_TINY, z_chd, z_rhy))
    notes = [jdemo.grid_to_pr_and_notes(g, bpm=bpm, spec=spec)[1]
             for g in grids]
    want = str(d / "gen_jax.mid")
    jdemo.write_demo(want, [notes], ["generated"], bpm=bpm, shift_beat=8)
    got = str(d / "gen_port.mid")
    generate.main(["--chords", "Am D7 G", "--bars", str(bars), "--out", got,
                   "--checkpoint", ck, "--texture-from", files["b"],
                   "--device", "cpu"])
    assert _bytes(got) == _bytes(want)


def test_generate_samples_from_the_prior(world):
    d, jp, _ = world
    ck = save_checkpoint(str(d / "ck_prior"), port_params(jp))
    runs = []
    for seed in (0, 0, 1):
        out = str(d / f"gen_prior_{len(runs)}.mid")
        generate.main(["--chords", "C-Am-F-G", "--samples", "2", "--out",
                       out, "--checkpoint", ck, "--seed", str(seed),
                       "--device", "cpu"])
        runs.append(_bytes(out))
        mf = MidiFile.read(out)
        assert [t.name for t in mf.tracks] == ["sample_0", "sample_1"]
    assert runs[0] == runs[1] != runs[2]


def test_train_cli_ingests_a_midi_directory(tmp_path, capsys):
    midi = tmp_path / "midi"
    os.makedirs(midi)
    for i in range(3):
        write_song(str(midi / f"s{i}.mid"), 20 + i, 6,
                   names=("a", "b", "c"))
    prefix = str(tmp_path / "cache" / "songs")
    # no epoch: the corpus is what is under test, and the run's first
    # steps are tested on the synthetic corpus elsewhere
    train.main(["--device", "cpu", "--midi-dir", str(midi),
                "--corpus-cache", prefix, "--epochs", "0",
                "--result-dir", str(tmp_path / "run")],
               model_config=tcfg.tiny_model_config())
    want = jingest_directory(str(midi))
    assert (f"corpus: {len(want[0])} train / {len(want[1])} val segments "
            f"(ingested MIDI at {midi})") in capsys.readouterr().out
    for split, w in zip(("train", "val"), want):
        got = np.load(f"{prefix}.{split}.npz")
        for f in ("pr", "mel", "chord", "song_id", "bar_pos"):
            np.testing.assert_array_equal(got[f], getattr(w, f))


@pytest.mark.parametrize("devices", [1, 2])
def test_data_parallel_flag_answers_as_without_it(world, monkeypatch,
                                                  devices):
    """``--data-parallel`` splits each chunk's rows over the devices of
    ``make_mesh()``: one CPU device as the CLI finds it, and two CPU
    devices in its place; every reply and file equals the run without the
    flag's, and the ready line names the device count."""
    d, jp, files = world
    ck = str(d / "ck_dp")
    checkpoint.save_params(ck, port_params(jp), TINY)
    if devices > 1:
        monkeypatch.setattr(serve, "make_mesh", lambda device_type: Mesh(
            (torch.device(device_type),) * devices))
    reqs = [
        {"op": "style_transfer", "content": files["a"], "style": files["b"],
         "fix": "chord"},
        {"op": "variation", "input": files["c"], "scale": 0.5, "seed": 1},
        {"op": "prior", "input": files["c"], "sample": "both", "seed": 2},
        {"op": "interp", "a": files["a"], "b": files["c"], "count": 2,
         "what": "texture"}]
    runs = []
    for flag in ([], ["--data-parallel"]):
        tag = "dp" if flag else "one"
        lines = [json.dumps(dict(r, out=str(d / f"{tag}_{i}_%d.mid")))
                 for i, r in enumerate(reqs)] + ['{"op": "quit"}']
        buf = io.StringIO()
        serve.main(["--checkpoint", ck, "--device", "cpu",
                    "--fixed-batch", "4", *flag],
                   stdin=io.StringIO("\n".join(lines) + "\n"), stdout=buf)
        out = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        ready = [ln for ln in out if ln.get("ready")][0]
        assert ready["devices"] == (devices if flag else 1)
        replies = [{k: v for k, v in ln.items() if k not in ("ms", "out")}
                   for ln in out if "ok" in ln]
        files_out = [_bytes(p) for ln in out if "out" in ln
                     for p in (ln["out"] if isinstance(ln["out"], list)
                               else [ln["out"]])]
        assert all(r["ok"] for r in replies) and len(files_out) == 5
        runs.append((replies, files_out))
    assert runs[0] == runs[1]
