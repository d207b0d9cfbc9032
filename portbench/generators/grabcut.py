"""Seeded GrabCut-style segmentation instances on 4-connected grids.

A batch is a clip: ``batch`` frames of one scene. A scene is a shaded
background with ``ellipses`` brighter objects; each frame moves every
object by a small random step (``jitter``, in half-widths of the image)
and adds Gaussian noise. The scenes and their frames are drawn from the
configuration's ``scene_seed``; the run's seed puts the frames of each
clip in an order of its own. So every seed gets the same work in another
order: the masked solve of a clip lasts as long as its slowest frame,
and the noise alone moved that frame's rounds, and a run's rate, by up
to 1.7x from seed to seed.

The energy is GrabCut's (Rother, Kolmogorov, Blake, SIGGRAPH 2004), on
the 4-neighbourhood:

* n-links ``gamma * exp(-beta (I_p - I_q)^2)`` with ``beta = 1 / (2
  <(I_p - I_q)^2>)`` over the frame's neighbour pairs, both directions
  alike;
* t-links ``-log p(I_p | class)`` under a two-class Gaussian intensity
  model (the scene's object and background means, a common spread
  ``model_sigma``), shifted so one of the two is 0 (Boykov and
  Kolmogorov, PAMI 2004): the source side is the object.

Capacities are ``round(quant * energy)``, integer-valued float32, with
each t-link clipped at ``tlink_max``; with at most 2**18 pixels of at
most 63 each, every max-flow value stays below 2**24, where float32
counts integers exactly.

The frames are drawn on ``device`` by one ``torch.Generator`` in a few
large calls per clip, the order on the host; the same seed on the same
device gives the same instances in the same order.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _scene(gen, p: dict, dev) -> dict:
    """One scene's geometry and intensities."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    k = int(p["ellipses"])
    return {"bg": u(*p["background"], 1), "slope": u(-p["shading"],
                                                     p["shading"], 2),
            "fg": u(*p["object"], 1), "cy": u(-0.6, 0.6, k),
            "cx": u(-0.6, 0.6, k), "ay": u(*p["axis"], k),
            "ax": u(*p["axis"], k), "th": u(0.0, math.pi, k)}


def _frames(gen, scene: dict, n: int, H: int, W: int, p: dict, dev):
    """``n`` frames ``(n, H, W)`` in [0, 1] of ``scene``."""
    y = torch.linspace(-1.0, 1.0, H, device=dev).view(1, H, 1)
    x = torch.linspace(-1.0, 1.0, W, device=dev).view(1, 1, W)
    img = (scene["bg"] + scene["slope"][0] * y + scene["slope"][1] * x
           ).expand(n, H, W)
    k = int(p["ellipses"])
    step = p["jitter"] * torch.randn((2, n, k), generator=gen, device=dev)
    inside = torch.zeros((n, H, W), dtype=torch.bool, device=dev)
    for j in range(k):
        dy = y - (scene["cy"][j] + step[0, :, j]).view(n, 1, 1)
        dx = x - (scene["cx"][j] + step[1, :, j]).view(n, 1, 1)
        c, s = torch.cos(scene["th"][j]), torch.sin(scene["th"][j])
        r = ((c * dx + s * dy) / scene["ax"][j]) ** 2 + \
            ((c * dy - s * dx) / scene["ay"][j]) ** 2
        inside |= r <= 1.0
    img = torch.where(inside, scene["fg"], img)
    img = img + p["noise"] * torch.randn((n, H, W), generator=gen,
                                         device=dev)
    return img.clamp(0.0, 1.0)


def capacities(img, fg_mean: float, bg_mean: float, p: dict, gamma: float):
    """Integer-valued float32 capacities ``(n, 4, H, W)``, ``(n, H, W)``,
    ``(n, H, W)`` of the GrabCut energy of the frames ``img``."""
    n, H, W = img.shape
    q = p["quant"]
    dv = img[:, 1:, :] - img[:, :-1, :]           # vertical pairs
    dh = img[:, :, 1:] - img[:, :, :-1]           # horizontal pairs
    mean_sq = ((dv ** 2).sum((1, 2)) + (dh ** 2).sum((1, 2))) / (
        dv[0].numel() + dh[0].numel())
    beta = (1.0 / (2.0 * mean_sq.clamp_min(1e-12))).view(n, 1, 1)
    wv = torch.round(q * gamma * torch.exp(-beta * dv ** 2))
    wh = torch.round(q * gamma * torch.exp(-beta * dh ** 2))
    cap = torch.zeros((n, 4, H, W), dtype=torch.float32, device=img.device)
    cap[:, 0, 1:, :] = wv          # UP: (i, j) -> (i - 1, j)
    cap[:, 1, :-1, :] = wv         # DOWN
    cap[:, 2, :, 1:] = wh          # LEFT
    cap[:, 3, :, :-1] = wh         # RIGHT
    var = 2.0 * p["model_sigma"] ** 2
    d_fg = (img - fg_mean) ** 2 / var             # -log p, less a constant
    d_bg = (img - bg_mean) ** 2 / var
    low = torch.minimum(d_fg, d_bg)
    top = float(p["tlink_max"])
    cap_src = torch.round(q * (d_bg - low)).clamp_max(top)
    cap_sink = torch.round(q * (d_fg - low)).clamp_max(top)
    return cap, cap_src, cap_sink


def make_pool(config: dict, traffic: dict, seed: int, device) -> list[list]:
    """``traffic["pool_batches"]`` clips of ``traffic["batch"]`` frames,
    each frame a ``(cap_nbr, cap_src, cap_sink)`` tuple of numpy float32
    arrays ``(4, H, W)``, ``(H, W)``, ``(H, W)``."""
    p = config["assumed"]["generator"]
    H, W = config["height"], config["width"]
    B = traffic["batch"]
    dev = torch.device(device)
    scenes = torch.Generator(device=dev)
    scenes.manual_seed(int(p["scene_seed"]))
    order = torch.Generator()
    order.manual_seed(int(seed))
    gamma = float(traffic["instance"]["gamma"])
    pool = []
    for _ in range(traffic["pool_batches"]):
        scene = _scene(scenes, p, dev)
        img = _frames(scenes, scene, B, H, W, p, dev)
        cap, cs, ct = (t.cpu().numpy() for t in capacities(
            img, scene["fg"], scene["bg"], p, gamma))
        pool.append([(cap[i], cs[i], ct[i])
                     for i in torch.randperm(B, generator=order).tolist()])
    return pool


def max_flow_bound(instance) -> float:
    """An upper bound on the instance's max-flow value: the capacity of
    every source edge (the cut with the whole grid on the sink side)."""
    return float(np.asarray(instance[1], np.float64).sum())
