"""Plain PyTorch reference of the serving workflows: the latent step of
each request (posterior means for a style transfer, draws from a seeded
generator for posterior and prior sampling, SLERP for interpolation) and
the teacher-forced logits of the grids a server returned, from which
the comparison reads the widest gap by which a served token's logit lies
below the reference's best. It imports nothing of the program under
test."""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from benchmark.reference.model import Reference

Tensor = torch.Tensor

#: rows the reference decodes at once
BLOCK_ROWS = 2048


def slerp(z1: np.ndarray, z2: np.ndarray, count: int) -> np.ndarray:
    """(count, d) points from z1 to z2 in float64: spherical interpolation
    of the directions, log-linear interpolation of the norms."""
    z1, z2 = z1.astype(np.float64), z2.astype(np.float64)
    n1, n2 = np.linalg.norm(z1), np.linalg.norm(z2)
    u1, u2 = z1 / n1, z2 / n2
    omega = np.arccos(np.clip(np.dot(u1, u2), -1.0, 1.0))
    t = np.linspace(0.0, 1.0, count)
    if np.sin(omega) < 1e-8:
        dirs = (1 - t)[:, None] * u1 + t[:, None] * u2
    else:
        dirs = (np.sin((1 - t) * omega)[:, None] * u1
                + np.sin(t * omega)[:, None] * u2) / np.sin(omega)
    norms = np.exp(np.linspace(np.log(n1), np.log(n2), count))
    return dirs * norms[:, None]


def latents(ref: Reference, req: dict, device) -> Tensor:
    """The latent codes (rows, z) a request decodes, in the row order of
    its grids (an interpolation: each pair's ``int_count`` points)."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    kind, a = req["kind"], req["args"]
    if kind == "swap":
        # "chord": the chords of source 1 under the texture of source 2;
        # "texture": the texture of source 1 under the chords of source 2
        one = a["fix"] == "chord"
        (m_c, _), (m_r, _) = ref.encode(t(req["pr2"] if one else req["pr1"]),
                                        t(req["c1"] if one else req["c2"]))
        return torch.cat([m_c, m_r], -1)
    if kind == "interp":
        (c1, _), (r1, _) = ref.encode(t(req["pr1"]), t(req["c1"]))
        (c2, _), (r2, _) = ref.encode(t(req["pr2"]), t(req["c2"]))
        n = a["int_count"]
        parts = []
        for z1, z2, on in ((c1, c2, a["what"] in ("chord", "both")),
                           (r1, r2, a["what"] in ("texture", "both"))):
            z1, z2 = z1.cpu().numpy(), z2.cpu().numpy()
            parts.append(np.stack([slerp(x, y, n) if on else
                                   np.repeat(x[None], n, 0)
                                   for x, y in zip(z1, z2)]))
        z = np.concatenate(parts, -1)
        return t(z.reshape(-1, z.shape[-1]))
    (m_c, s_c), (m_r, s_r) = ref.encode(t(req["pr1"]), t(req["c1"]))
    gen = torch.Generator(device=device).manual_seed(req["seed"])
    eps_c = torch.randn(m_c.shape, generator=gen, device=device)
    eps_r = torch.randn(m_r.shape, generator=gen, device=device)
    if kind == "posterior_sample":
        scale = a["scale"]
        return torch.cat([m_c + s_c * scale * eps_c,
                          m_r + s_r * scale * eps_r], -1)
    if kind == "prior_sample":
        scale = a["scale"]
        z_c = (scale * eps_c if a["sample"] in ("chord", "both")
               else m_c + s_c * eps_c)
        z_r = (scale * eps_r if a["sample"] in ("texture", "both")
               else m_r + s_r * eps_r)
        return torch.cat([z_c, z_r], -1)
    raise ValueError(f"request kind {kind!r}")


def _valid(grid: Tensor, P: int) -> bool:
    return bool(((grid[..., 0] >= 0) & (grid[..., 0] < P)).all()
                and ((grid[..., 1:] == 0) | (grid[..., 1:] == 1)).all())


def token_gaps(pitch_logits: Tensor, dur_logits: Tensor, grid: Tensor
               ) -> float:
    """The widest gap by which the logit of a token of ``grid`` (rows, T,
    K-1, 1 + W) lies below the best logit at its position."""
    g_p = pitch_logits.max(-1).values - pitch_logits.gather(
        -1, grid[..., :1].long())[..., 0]
    g_d = dur_logits.max(-1).values - dur_logits.gather(
        -1, grid[..., 1:, None].long())[..., 0]
    return max(float(g_p.max()), float(g_d.max()))


def argmax_grid(pitch_logits: Tensor, dur_logits: Tensor) -> Tensor:
    """The tokens a decoder puts first: the pitch argmax, and a bit where
    logit 1 > logit 0."""
    return torch.cat([pitch_logits.argmax(-1)[..., None],
                      (dur_logits[..., 1] > dur_logits[..., 0]).long()], -1)


def _blocks(items: List[Tuple[Tensor, Tensor]]):
    """Concatenate (z, grid) pairs and cut them into blocks of rows."""
    z = torch.cat([i[0] for i in items])
    g = torch.cat([i[1] for i in items])
    for lo in range(0, z.shape[0], BLOCK_ROWS):
        yield z[lo:lo + BLOCK_ROWS], g[lo:lo + BLOCK_ROWS]


@torch.no_grad()
def served_gap(ref: Reference, served: Iterable[Tuple[dict, np.ndarray]],
               device) -> float:
    """The widest logit gap of the served tokens of ``served``: (request,
    its grid as returned) pairs. A grid of the wrong shape or with a token
    outside the vocabulary reads inf."""
    items = []
    w = ref.w
    for req, grid in served:
        z = latents(ref, req, device)
        g = torch.as_tensor(np.asarray(grid), device=device)
        g = g.reshape(-1, *g.shape[-3:])
        if (g.shape != (z.shape[0], w.T, w.K - 1, 1 + w.W)
                or not _valid(g, w.P)):
            return float("inf")
        items.append((z, g))
    return max(token_gaps(*ref.decode_served(z, g), g)
               for z, g in _blocks(items))


@torch.no_grad()
def control_gap(ref: Reference, control: Reference,
                served: Iterable[Tuple[dict, np.ndarray]], device,
                control_context) -> float:
    """The lower-precision control in the server's place: at each position
    of the served tokens, the gap, under ``ref``, of the token that
    ``control`` (run inside ``control_context()``) puts first."""
    items = []
    for req, grid in served:
        z = latents(ref, req, device)
        with control_context():
            zc = latents(control, req, device)
        g = torch.as_tensor(np.asarray(grid), device=device)
        items.append((torch.cat([z, zc], -1),
                      g.reshape(-1, *g.shape[-3:])))
    gap, nz = 0.0, ref.w.z
    for zz, g in _blocks(items):
        with control_context():
            top = argmax_grid(*control.decode_served(zz[:, nz:], g))
        gap = max(gap, token_gaps(*ref.decode_served(zz[:, :nz], g), top))
    return gap
