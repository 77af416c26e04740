"""Plain PyTorch reference of the chord/texture disentangled VAE (Wang et
al., ISMIR 2020): chord encoder, conv or PianoTree texture encoder, chord
decoder and the PianoTree decoder, written from the published model in
plain tensor operations, float32, with no kernel, cache or fold.

It imports nothing of the program under test. Parameters are a flat dict
``{"dec/notes_gru/w_ih": tensor, ...}``: dense weights ``(in, out)``, conv
weights HWIO, GRU weights ``(in, 3H)`` with the gates in the order
(r, z, n) and ``b_hh`` inside the reset product, as ``torch.nn.GRU``.

``tf32="emulate"`` rounds both operands of every product to TF32 (10
mantissa bits) before an f32 product: the lower-precision control on a
machine without TF32 units. On the card the control instead runs these
functions with ``torch.backends.cuda.matmul.allow_tf32`` on.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class Widths(NamedTuple):
    """The sizes of one configuration (``configs/<name>.json``)."""
    chd_z: int
    txt_z: int
    chd_enc_h: int
    txt_encoder: str
    conv_ch: int
    txt_emb: int
    txt_enc_h: int
    pt_pitch_range: int
    pt_note_emb: int
    pt_notes_h: int
    pt_time_h: int
    chd_dec_h: int
    chd_dec_z_in: int
    note_emb: int
    emb_h: int
    time_h: int
    notes_h: int
    dec_z_in: int
    dur_h: int
    T: int
    K: int
    min_pitch: int
    pitch_sos: int
    pitch_eos: int
    pitch_pad: int
    dur_pad: int
    W: int
    P: int
    chord_steps: int
    chord_dim: int

    @property
    def z(self) -> int:
        return self.chd_z + self.txt_z

    @property
    def note_size(self) -> int:
        return self.P + self.W


def widths_of(cfg: dict) -> Widths:
    """:class:`Widths` of a configuration file's ``model``, ``pianotree``
    and ``chord`` sections."""
    m, pt, ch = cfg["model"], cfg["pianotree"], cfg["chord"]
    return Widths(
        chd_z=m["chd_z_dim"], txt_z=m["txt_z_dim"],
        chd_enc_h=m["chd_enc_hidden"], txt_encoder=m["txt_encoder"],
        conv_ch=m["txt_conv_channels"], txt_emb=m["txt_emb_size"],
        txt_enc_h=m["txt_enc_hidden"],
        pt_pitch_range=m["ptenc_max_pitch"] - m["ptenc_min_pitch"] + 3,
        pt_note_emb=m["ptenc_note_emb"], pt_notes_h=m["ptenc_notes_hidden"],
        pt_time_h=m["ptenc_time_hidden"], chd_dec_h=m["chd_dec_hidden"],
        chd_dec_z_in=m["chd_dec_z_in"], note_emb=m["note_emb_size"],
        emb_h=m["dec_emb_hidden"], time_h=m["dec_time_hidden"],
        notes_h=m["dec_notes_hidden"], dec_z_in=m["dec_z_in"],
        dur_h=m["dec_dur_hidden"], T=pt["num_step"], K=pt["max_simu_note"],
        min_pitch=pt["min_pitch"], pitch_sos=pt["pitch_sos"],
        pitch_eos=pt["pitch_eos"], pitch_pad=pt["pitch_pad"],
        dur_pad=pt["dur_pad"], W=pt["dur_width"],
        P=pt["max_pitch"] - pt["min_pitch"] + 3,
        chord_steps=ch["num_step"], chord_dim=ch["dim"])


# -- the parameters -----------------------------------------------------------

def _dense(name: str, i: int, o: int):
    s = 1.0 / math.sqrt(i)
    return [(f"{name}/w", (i, o), s), (f"{name}/b", (o,), s)]


def _gru(name: str, i: int, h: int):
    s = 1.0 / math.sqrt(h)
    return [(f"{name}/w_ih", (i, 3 * h), s), (f"{name}/w_hh", (h, 3 * h), s),
            (f"{name}/b_ih", (3 * h,), s), (f"{name}/b_hh", (3 * h,), s)]


def leaf_specs(w: Widths
               ) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """Every parameter as (name, shape, scale): drawn from U(-scale, scale)
    (PyTorch's default init of dense, conv and GRU layers), or from U(0, 1)
    where the scale is None (the free parameters, ``torch.rand``)."""
    specs = (_gru("chd_enc/gru_fwd", w.chord_dim, w.chd_enc_h)
             + _gru("chd_enc/gru_bwd", w.chord_dim, w.chd_enc_h)
             + _dense("chd_enc/mu", 2 * w.chd_enc_h, w.chd_z)
             + _dense("chd_enc/std", 2 * w.chd_enc_h, w.chd_z))
    if w.txt_encoder == "conv":
        H, Wd = (w.T - 4) // 4 + 1, (128 - 12 + 1) // 4
        s = 1.0 / math.sqrt(4 * 12)
        specs += [("txt_enc/conv/w", (4, 12, 1, w.conv_ch), s),
                  ("txt_enc/conv/b", (w.conv_ch,), s)]
        specs += (_dense("txt_enc/fc1", w.conv_ch * H * Wd // 8, 1000)
                  + _dense("txt_enc/fc2", 1000, w.txt_emb)
                  + _gru("txt_enc/gru_fwd", w.txt_emb, w.txt_enc_h)
                  + _gru("txt_enc/gru_bwd", w.txt_emb, w.txt_enc_h)
                  + _dense("txt_enc/mu", 2 * w.txt_enc_h, w.txt_z)
                  + _dense("txt_enc/std", 2 * w.txt_enc_h, w.txt_z))
    elif w.txt_encoder == "pianotree":
        ns = w.pt_pitch_range + w.W
        specs += (_dense("txt_enc/note_emb", ns, w.pt_note_emb)
                  + _gru("txt_enc/notes_fwd", w.pt_note_emb, w.pt_notes_h)
                  + _gru("txt_enc/notes_bwd", w.pt_note_emb, w.pt_notes_h)
                  + _gru("txt_enc/time_fwd", 2 * w.pt_notes_h, w.pt_time_h)
                  + _gru("txt_enc/time_bwd", 2 * w.pt_notes_h, w.pt_time_h)
                  + _dense("txt_enc/mu", 2 * w.pt_time_h, w.txt_z)
                  + _dense("txt_enc/std", 2 * w.pt_time_h, w.txt_z))
    else:
        raise ValueError(f"texture encoder {w.txt_encoder!r}")
    specs += (_dense("dec/note_emb", w.note_size, w.note_emb)
              + _dense("dec/z2hid", w.z, w.time_h)
              + _dense("dec/z2in", w.z, w.dec_z_in)
              + _gru("dec/emb_fwd", w.note_emb, w.emb_h)
              + _gru("dec/emb_bwd", w.note_emb, w.emb_h)
              + _gru("dec/time_gru", w.dec_z_in + 2 * w.emb_h, w.time_h)
              + _dense("dec/time2notes", w.time_h, w.notes_h)
              + _gru("dec/notes_gru", w.time_h + w.note_emb, w.notes_h)
              + _dense("dec/pitch_out", w.notes_h, w.P)
              + _gru("dec/dur_gru", w.W, w.dur_h)
              + _dense("dec/dur_hid", w.P + w.notes_h, w.dur_h)
              + _dense("dec/dur_out", w.dur_h, 2)
              + [("dec/init_input", (2 * w.emb_h,), None),
                 ("dec/dur_sos", (w.W,), None)])
    specs += (_dense("chd_dec/z2hid", w.chd_z, w.chd_dec_h)
              + _dense("chd_dec/z2in", w.chd_z, w.chd_dec_z_in)
              + _gru("chd_dec/gru", w.chord_dim + w.chd_dec_z_in, w.chd_dec_h)
              + _dense("chd_dec/root", w.chd_dec_h, 12)
              + _dense("chd_dec/chroma", w.chd_dec_h, 24)
              + _dense("chd_dec/bass", w.chd_dec_h, 12)
              + [("chd_dec/init_input", (w.chord_dim,), None)])
    return specs


def make_weights(w: Widths, seed: int, device) -> Dict[str, Tensor]:
    """Random weights from ``seed``: one uniform draw of every element by a
    generator on ``device``, scaled leaf by leaf, each leaf its own tensor."""
    specs = leaf_specs(w)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    lo = torch.tensor([0.0 if s is None else -s for _, _, s in specs],
                      device=device)
    span = torch.tensor([1.0 if s is None else 2 * s for _, _, s in specs],
                        device=device)
    reps = torch.tensor(sizes, device=device)
    u = (torch.repeat_interleave(lo, reps)
         + u * torch.repeat_interleave(span, reps))
    return {name: t.reshape(shape).clone()
            for (name, shape, _), t in zip(specs, u.split(sizes))}


# -- arithmetic ---------------------------------------------------------------

def _round_tf32(x: Tensor) -> Tensor:
    """``x`` rounded to TF32 (nearest, ties to even on the 13 dropped
    mantissa bits), with the gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


class Reference:
    """The model over a flat parameter dict; ``tf32="emulate"`` makes every
    product a TF32 product (see the module docstring). ``margin``, where
    set to a tensor, keeps the smallest gap between the best and the
    second logit of every argmax decision the decode feeds back."""

    def __init__(self, params: Dict[str, Tensor], w: Widths,
                 tf32: str = "off"):
        if tf32 not in ("off", "emulate"):
            raise ValueError(f"tf32 {tf32!r}")
        self.p, self.w = params, w
        self.emulate = tf32 == "emulate"
        self.margin: Optional[Tensor] = None

    def _decided(self, logits: Tensor) -> None:
        if self.margin is not None:
            top = logits.detach().topk(2, -1).values
            self.margin = torch.minimum(self.margin,
                                        (top[..., 0] - top[..., 1]).min())

    # products
    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.emulate:
            a, b = _round_tf32(a), _round_tf32(b)
        return a @ b

    def lin(self, name: str, x: Tensor) -> Tensor:
        return self.mm(x, self.p[f"{name}/w"]) + self.p[f"{name}/b"]

    def cell(self, name: str, gi: Tensor, h: Tensor) -> Tensor:
        """One GRU step from the input gates ``gi`` (x @ w_ih + b_ih)."""
        gh = self.mm(h, self.p[f"{name}/w_hh"]) + self.p[f"{name}/b_hh"]
        ir, iz, i_n = gi.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * hn)
        return (1.0 - z) * n + z * h

    def gates_in(self, name: str, x: Tensor) -> Tensor:
        return self.mm(x, self.p[f"{name}/w_ih"]) + self.p[f"{name}/b_ih"]

    def bigru(self, fwd: str, bwd: str, xs: Tensor,
              lengths: Optional[Tensor] = None) -> Tensor:
        """[last forward hidden | last backward hidden] of a bidirectional
        GRU over xs (B, L, D), as ``pack_padded_sequence`` gives it for
        ``lengths``: steps at or past a row's length leave its hidden as
        it is."""
        B, L, _ = xs.shape
        out = []
        for name, steps in ((fwd, range(L)), (bwd, range(L - 1, -1, -1))):
            gi = self.gates_in(name, xs)
            h = xs.new_zeros((B, self.p[f"{name}/w_hh"].shape[0]))
            for t in steps:
                new = self.cell(name, gi[:, t], h)
                h = new if lengths is None else torch.where(
                    (t < lengths)[:, None], new, h)
            out.append(h)
        return torch.cat(out, -1)

    def gaussian(self, prefix: str, h: Tensor) -> Tuple[Tensor, Tensor]:
        return (self.lin(f"{prefix}/mu", h),
                torch.exp(self.lin(f"{prefix}/std", h)))

    # encoders
    def chord_encoder(self, c: Tensor) -> Tuple[Tensor, Tensor]:
        """c (B, 8, 36) -> (mean, std) of the chord latent."""
        return self.gaussian("chd_enc", self.bigru(
            "chd_enc/gru_fwd", "chd_enc/gru_bwd", c))

    def conv_encoder(self, pr_mat: Tensor) -> Tuple[Tensor, Tensor]:
        """pr_mat (B, T, 128) duration matrix -> (mean, std): conv 4x12 at
        stride (4, 1), ReLU, max pool 1x4, the (B, C, 8, 29) map viewed as
        8 steps, two dense layers, a bidirectional GRU."""
        B = pr_mat.shape[0]
        wt = self.p["txt_enc/conv/w"].permute(3, 2, 0, 1)   # HWIO -> OIHW
        x = pr_mat[:, None]
        if self.emulate:
            x, wt = _round_tf32(x), _round_tf32(wt)
        x = F.conv2d(x, wt, self.p["txt_enc/conv/b"], stride=(4, 1))
        x = F.max_pool2d(F.relu(x), (1, 4))
        x = x.reshape(B, 8, -1)
        x = self.lin("txt_enc/fc2", self.lin("txt_enc/fc1", x))
        return self.gaussian("txt_enc", self.bigru(
            "txt_enc/gru_fwd", "txt_enc/gru_bwd", x))

    def pianotree_encoder(self, dt_x: Tensor) -> Tuple[Tensor, Tensor]:
        """dt_x (B, T, K, 39) detrended grid -> (mean, std): note
        embedding, a bidirectional GRU over each step's notes (pad notes
        masked), a bidirectional GRU over the steps."""
        B, T, K, _ = dt_x.shape
        lengths = (K - dt_x[..., 3].sum(-1)).to(torch.int64)
        emb = self.lin("txt_enc/note_emb", dt_x).reshape(B * T, K, -1)
        notes = self.bigru("txt_enc/notes_fwd", "txt_enc/notes_bwd", emb,
                           lengths.reshape(B * T))
        return self.gaussian("txt_enc", self.bigru(
            "txt_enc/time_fwd", "txt_enc/time_bwd", notes.reshape(B, T, -1)))

    def encode(self, pr_mat: Tensor, c: Tensor, dt_x: Optional[Tensor] = None):
        """((chord mean, std), (texture mean, std))."""
        txt = (self.conv_encoder(pr_mat) if self.w.txt_encoder == "conv"
               else self.pianotree_encoder(dt_x))
        return self.chord_encoder(c), txt

    # the PianoTree decoder
    def note_embedding(self, pitch: Tensor, dur: Tensor) -> Tensor:
        """Notes (pitch index, W duration values) -> embeddings: the pitch
        one-hot (the pad index gives zeros) and the raw duration values."""
        oh = F.one_hot(pitch.long(), self.w.P + 1)[..., :self.w.P]
        return self.lin("dec/note_emb",
                        torch.cat([oh, dur], -1).to(torch.float32))

    def sos_embedding(self, B: int, device) -> Tensor:
        w = self.w
        return self.note_embedding(
            torch.full((B,), w.pitch_sos, device=device),
            torch.full((B, w.W), float(w.dur_pad), device=device))

    def _frame(self, h_t: Tensor, first: Tensor, coins=None, gt_emb=None,
               served=None):
        """One frame of the note and duration levels from the time hidden
        h_t (B, TH), starting from the token ``first`` (B, E). With
        ``served`` = (pitch (B, K-1), bits (B, K-1, W)) every decision is
        the served one; else each is the argmax (a bit is logit 1 > logit
        0), and the next slot reads the ground-truth embedding ``gt_emb[:,
        k]`` where ``coins[k - 1]``. Returns (pitch logits (B, K-1, P),
        duration logits (B, K-1, W, 2), the summary of the frame's notes
        (B, 2 EH))."""
        w, p = self.w, self.p
        B = h_t.shape[0]
        hn = self.lin("dec/time2notes", h_t)
        gi_frame = self.mm(h_t, p["dec/notes_gru/w_ih"][:w.time_h])
        gi_frame = gi_frame + p["dec/notes_gru/b_ih"]
        w_tok = p["dec/notes_gru/w_ih"][w.time_h:]
        d_sos = self.mm(p["dec/dur_sos"][None], p["dec/dur_gru/w_ih"])
        d_rows = p["dec/dur_gru/w_ih"][:2] + p["dec/dur_gru/b_ih"]
        token = first
        embs, pitch_logits, dur_logits = [first], [], []
        lengths = torch.zeros(B, dtype=torch.int64, device=h_t.device)
        for k in range(1, w.K):
            hn = self.cell("dec/notes_gru", gi_frame + self.mm(token, w_tok),
                           hn)
            est = self.lin("dec/pitch_out", hn)
            if served is None:
                pitch = est.argmax(-1)
                self._decided(est)
            else:
                pitch = served[0][:, k - 1]
            hd = self.lin("dec/dur_hid", torch.cat([hn, est], -1))
            gi_d = (d_sos + p["dec/dur_gru/b_ih"]).expand(B, -1)
            logits, bits = [], []
            for i in range(w.W):
                hd = self.cell("dec/dur_gru", gi_d, hd)
                logit = self.lin("dec/dur_out", hd)
                if served is None:
                    bit = logit[:, 1] > logit[:, 0]
                    self._decided(logit)
                else:
                    bit = served[1][:, k - 1, i] != 0
                gi_d = torch.where(bit[:, None], d_rows[1], d_rows[0])
                logits.append(logit)
                bits.append(bit)
            bits = torch.stack(bits, -1).to(torch.float32)
            emb = self.note_embedding(pitch, bits)
            first_eos = (pitch == w.pitch_eos) & (lengths == 0)
            lengths = torch.where(first_eos, k, lengths)
            token = emb if coins is None else torch.where(
                coins[k - 1], gt_emb[:, k], emb)
            embs.append(emb)
            pitch_logits.append(est)
            dur_logits.append(torch.stack(logits, 1))
        lengths = torch.where(lengths == 0, w.K - 1, lengths)
        summary = self.bigru("dec/emb_fwd", "dec/emb_bwd",
                             torch.stack(embs, 1), lengths)
        return (torch.stack(pitch_logits, 1), torch.stack(dur_logits, 1),
                summary)

    def _time_level(self, z: Tensor, frame, next_token):
        """The time GRU over T frames: ``frame(t, h)`` -> (out, summary),
        ``next_token(t, summary)`` the next frame's token."""
        w, p = self.w, self.p
        B = z.shape[0]
        h = self.lin("dec/z2hid", z)
        z_in = self.lin("dec/z2in", z)
        token = p["dec/init_input"].expand(B, -1)
        outs = []
        for t in range(w.T):
            h = self.cell("dec/time_gru", self.gates_in(
                "dec/time_gru", torch.cat([token, z_in], -1)), h)
            out, summary = frame(t, h)
            token = next_token(t, summary)
            outs.append(out)
        return outs

    def decode_served(self, z: Tensor, grid: Tensor) -> Tuple[Tensor, Tensor]:
        """Teacher-forced logits of a served grid (B, T, K-1, 1 + W) int:
        every decision fed back is the served one. Returns pitch logits
        (B, T, K-1, P) and duration logits (B, T, K-1, W, 2)."""
        sos = self.sos_embedding(z.shape[0], z.device)

        def frame(t, h):
            pl, dl, summary = self._frame(
                h, sos, served=(grid[:, t, :, 0], grid[:, t, :, 1:]))
            return (pl, dl), summary

        outs = self._time_level(z, frame, lambda t, s: s)
        return (torch.stack([o[0] for o in outs], 1),
                torch.stack([o[1] for o in outs], 1))

    def decode_teacher(self, z: Tensor, x: Tensor, coins1: Tensor,
                       coins2: Tensor) -> Tuple[Tensor, Tensor]:
        """The training decode of grid x (B, T, K, 1 + W): argmax feedback,
        the ground-truth note as the next slot's token where coins2[t, k],
        the ground-truth frame summary as the next time token where
        coins1[t]. Returns pitch logits (B, T, K-1, P) and duration logits
        (B, T, K-1, W, 2)."""
        w = self.w
        B = x.shape[0]
        x_emb = self.note_embedding(x[..., 0], x[..., 1:].to(torch.float32))
        x_len = w.K - (x[..., 0] == w.pitch_pad).sum(-1)
        x_summary = self.bigru(
            "dec/emb_fwd", "dec/emb_bwd", x_emb.reshape(B * w.T, w.K, -1),
            x_len.reshape(B * w.T)).reshape(B, w.T, -1)

        def frame(t, h):
            pl, dl, summary = self._frame(h, x_emb[:, t, 0],
                                          coins=coins2[t, 1:],
                                          gt_emb=x_emb[:, t])
            return (pl, dl), summary

        outs = self._time_level(
            z, frame,
            lambda t, s: torch.where(coins1[t], x_summary[:, t], s))
        return (torch.stack([o[0] for o in outs], 1),
                torch.stack([o[1] for o in outs], 1))

    def chord_decoder(self, z_chd: Tensor, c: Tensor, coins3: Tensor):
        """Root (B, S, 12), chroma (B, S, 12, 2) and bass (B, S, 12) logits
        of the chord decoder: argmax feedback, the ground-truth beat where
        coins3[t]."""
        w, p = self.w, self.p
        B = z_chd.shape[0]
        h = self.lin("chd_dec/z2hid", z_chd)
        z_in = self.lin("chd_dec/z2in", z_chd)
        token = p["chd_dec/init_input"].expand(B, -1)
        roots, chromas, basses = [], [], []
        for t in range(w.chord_steps):
            h = self.cell("chd_dec/gru", self.gates_in(
                "chd_dec/gru", torch.cat([token, z_in], -1)), h)
            root = self.lin("chd_dec/root", h)
            chroma = self.lin("chd_dec/chroma", h).reshape(B, 12, 2)
            bass = self.lin("chd_dec/bass", h)
            roots.append(root)
            chromas.append(chroma)
            basses.append(bass)
            pred = torch.cat([F.one_hot(root.argmax(-1), 12),
                              chroma.argmax(-1),
                              F.one_hot(bass.argmax(-1), 12)],
                             -1).to(torch.float32)
            token = torch.where(coins3[t], c[:, t], pred)
        return (torch.stack(roots, 1), torch.stack(chromas, 1),
                torch.stack(basses, 1))


# -- the training loss --------------------------------------------------------

METRIC_NAMES = ("loss", "recon_loss", "pl", "dl", "kl_loss", "kl_chd",
                "kl_rhy", "chord_loss", "root_loss", "chroma_loss",
                "bass_loss")


def _nll(logits: Tensor, target: Tensor) -> Tensor:
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, target[..., None].long())[..., 0])


def _masked_ce(logits: Tensor, target: Tensor, pad: int):
    """(sum of the NLL over targets other than ``pad``, their count)."""
    mask = target != pad
    nll = _nll(logits, torch.where(mask, target, torch.zeros_like(target)))
    return (nll * mask).sum(), mask.sum()


def _kl(mean: Tensor, std: Tensor) -> Tensor:
    """KL(N(mean, std) || N(0, 1)), the mean over rows and dimensions."""
    return (0.5 * (std * std + mean * mean - 1.0) - torch.log(std)).mean()


def loss(ref: Reference, x: Tensor, c: Tensor, pr_mat: Tensor,
         dt_x: Optional[Tensor], eps_chd: Tensor, eps_rhy: Tensor,
         coins1: Tensor, coins2: Tensor, coins3: Tensor, beta: float,
         weights=(1.0, 0.5)) -> Dict[str, Tensor]:
    """The ELBO and the auxiliary chord loss of a batch (grid x, chords c,
    duration matrix pr_mat, detrended grid dt_x for the PianoTree
    encoder), with the latent noise and the teacher coins given: the 11
    metrics by :data:`METRIC_NAMES`. The reconstruction CE is over slots
    1..K-1 with pad targets left out; the duration CE pools every bit."""
    w = ref.w
    (m_c, s_c), (m_r, s_r) = ref.encode(pr_mat, c, dt_x)
    z_chd = m_c + s_c * eps_chd
    z = torch.cat([z_chd, m_r + s_r * eps_rhy], -1)
    pitch_l, dur_l = ref.decode_teacher(z, x, coins1, coins2)
    num_p, den_p = _masked_ce(pitch_l, x[:, :, 1:, 0], w.pitch_pad)
    num_d, den_d = _masked_ce(dur_l, x[:, :, 1:, 1:], w.dur_pad)
    pl = num_p / den_p.clamp(min=1)
    dl = num_d / den_d.clamp(min=1)
    recon = weights[0] * pl + weights[1] * dl
    kl_chd, kl_rhy = _kl(m_c, s_c), _kl(m_r, s_r)
    root, chroma, bass = ref.chord_decoder(z_chd, c, coins3)
    root_l = _nll(root, c[..., 0:12].argmax(-1)).mean()
    chroma_l = _nll(chroma, c[..., 12:24].long()).mean()
    bass_l = _nll(bass, c[..., 24:].argmax(-1)).mean()
    chord = root_l + chroma_l + bass_l
    kl = kl_chd + kl_rhy
    total = recon + beta * kl + chord
    return dict(zip(METRIC_NAMES, (total, recon, pl, dl, kl, kl_chd, kl_rhy,
                                   chord, root_l, chroma_l, bass_l)))
