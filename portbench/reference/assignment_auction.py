"""Plain reference of batched cost-scaling assignment with auction rounds.

A frozen, self-contained copy of the algorithm the configuration names
(arXiv:1110.6231 §5: Goldberg's ε-scaling on scaled costs ``c = -(n+1)
w``, ε divided by ``alpha`` down to 1; each refine run as synchronous
top-2 bidding rounds, a Bellman–Ford price update every
``rounds_per_heuristic`` rounds, arc fixing at each refine's exit;
finished instances frozen by a liveness mask). Plain PyTorch, importing
nothing of the program under test. Every cost, price and counter is an
integer of ``dtype`` (int32 as the configuration states; the control
lowers it); division floors; argmin takes the first index of a tie.

``optimal`` is a certificate that needs no trajectory: a perfect matching
is a maximum-weight one exactly when no cyclic reassignment of its
columns gains weight, which Bellman–Ford finds as a negative cycle.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AssignAnswer(NamedTuple):
    col_of_row: torch.Tensor  # (B, n) int: the column of each row; n = none
    weight: torch.Tensor      # (B,) int64 total weight of the matching
    rounds: torch.Tensor      # (B,) bidding rounds over all refines
    converged: torch.Tensor   # (B,) bool: a perfect matching at ε = 1


def _limits(dtype):
    """Cost infinity and price-update distance infinity for ``dtype``."""
    if dtype == torch.int32:
        return 2 ** 30, 2 ** 26
    top = torch.iinfo(dtype).max
    return (top + 1) // 2, (top + 1) // 16


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _ceildiv(a, b):
    return -_floordiv(-a, b)


def _onehot_last(idx, n):
    return idx.unsqueeze(-1) == torch.arange(n, device=idx.device)


def _onehot_rows(idx, n):
    return torch.arange(n, device=idx.device).unsqueeze(-1) == idx.unsqueeze(-2)


def _perfect(F):
    n = F.shape[-1]
    return ((F.sum((-2, -1)) == n) & (F.sum(-2) <= 1).all(-1)
            & (F.sum(-1) <= 1).all(-1))


class _State(NamedTuple):
    eps: torch.Tensor
    k: torch.Tensor
    alive: torch.Tensor
    F: torch.Tensor
    p_x: torch.Tensor
    p_y: torch.Tensor
    fixed: torch.Tensor
    rounds: torch.Tensor


class Auction:
    """The solver at one integer ``dtype``; ``solve`` runs a batch."""

    def __init__(self, *, alpha: int, rounds_per_heuristic: int,
                 max_rounds: int, dtype=torch.int32):
        self.alpha = alpha
        self.rph = rounds_per_heuristic
        self.max_rounds = max_rounds
        self.dt = dtype
        self.inf, self.inf_d = _limits(dtype)

    def _int(self, t):
        return t.to(self.dt)

    def _reprice_x(self, c, eps, p_y, fixed):
        """Refine entry: empty flow, ``p(x) = -min_y (c(x,y) - p(y) + ε)``."""
        cpx = torch.where(fixed, self.inf, c - p_y.unsqueeze(-2))
        return self._int(-(torch.amin(cpx, dim=-1) + eps.unsqueeze(-1)))

    def _round(self, c, eps, s: _State) -> _State:
        n = c.shape[-1]
        F, p_x, p_y = s.F, s.p_x, s.p_y
        e1 = eps.unsqueeze(-1)
        active = F.sum(-1) == 0
        cpx = torch.where(s.fixed, self.inf, c - p_y.unsqueeze(-2))
        min1 = torch.amin(cpx, dim=-1)
        arg1 = torch.argmin(cpx, dim=-1)
        min2 = torch.amin(torch.where(_onehot_last(arg1, n), self.inf, cpx),
                          dim=-1)
        min2 = torch.where(min2 >= self.inf, min1, min2)
        strength = self._int(min1 - min2 - e1)
        bids = torch.where(_onehot_last(arg1, n) & active.unsqueeze(-1),
                           strength.unsqueeze(-1), self.inf)
        best = torch.amin(bids, dim=-2)
        winner = torch.argmin(bids, dim=-2)
        got = best < self.inf
        F = (F * self._int((~got).unsqueeze(-2))
             + self._int(_onehot_rows(winner, n) & got.unsqueeze(-2)))
        p_y = self._int(torch.where(got, p_y + best, p_y))
        rows = torch.arange(n, device=c.device)
        won = (active & (torch.gather(winner, -1, arg1) == rows)
               & torch.gather(got, -1, arg1))
        p_x = self._int(torch.where(won, -(min2 + e1), p_x))
        return s._replace(F=F, p_x=p_x, p_y=p_y, rounds=s.rounds + 1)

    def _price_update(self, c, eps, s: _State) -> _State:
        """Bellman–Ford distances (in ε units) back from the unmatched
        columns along residual arcs, then ``p -= ε · distance``."""
        n = c.shape[-1]
        F, p_x, p_y = s.F, s.p_x, s.p_y
        inf, inf_d = self.inf, self.inf_d
        e1, e2 = eps.unsqueeze(-1), eps[:, None, None]
        l_y0 = self._int(torch.where(F.sum(-2) == 0, 0, inf_d))
        cp_xy = torch.where(s.fixed, inf, c + p_x.unsqueeze(-1)
                            - p_y.unsqueeze(-2))
        len_xy = torch.clamp(_floordiv(cp_xy, e2) + 1, 0, inf_d)
        len_xy = torch.where((F == 0) & (cp_xy < inf), len_xy, inf_d)
        cp_yx = -c + p_y.unsqueeze(-2) - p_x.unsqueeze(-1)
        len_yx = torch.where(F == 1, torch.clamp(_floordiv(cp_yx, e2) + 1, 0,
                                                 inf_d), inf_d)
        l_x, l_y = torch.full_like(p_x, inf_d), l_y0
        for _ in range(2 * n):
            nl_x = torch.minimum(l_x, torch.amin(torch.clamp(
                len_xy + l_y.unsqueeze(-2), max=inf_d), dim=-1))
            nl_y = torch.amin(torch.clamp(len_yx + nl_x.unsqueeze(-1),
                                          max=inf_d), dim=-2)
            nl_y = torch.minimum(torch.minimum(l_y, nl_y), l_y0)
            moved = bool(((nl_x != l_x).any() | (nl_y != l_y).any()).item())
            l_x, l_y = nl_x, nl_y
            if not moved:
                break
        rx, ry = l_x < inf_d, l_y < inf_d
        last = torch.maximum(torch.where(rx, l_x, 0).amax(-1),
                             torch.where(ry, l_y, 0).amax(-1))
        l_x = torch.where(rx, l_x, last.unsqueeze(-1) + 1)
        l_y = torch.where(ry, l_y, last.unsqueeze(-1) + 1)
        return s._replace(p_x=self._int(p_x - e1 * l_x),
                          p_y=self._int(p_y - e1 * l_y))

    def _cycle(self, c, s: _State) -> _State:
        n = c.shape[-1]
        eps = s.eps
        new = s
        for _ in range(self.rph):
            new = self._round(c, eps, new)
        perfect = _perfect(new.F)
        new = _select(~perfect, self._price_update(c, eps, new), new)
        k = self._int(new.k + self.rph)
        done = _perfect(new.F) | (k >= self.max_rounds)
        cp = c + new.p_x.unsqueeze(-1) - new.p_y.unsqueeze(-2)
        fix = new.fixed | ((cp > 2 * n * eps[:, None, None]) & (new.F == 0))
        fixed = torch.where(done[:, None, None], fix, new.fixed)
        alive = s.alive & ~(done & (eps <= 1))
        eps_next = self._int(torch.where(
            done & (eps > 1),
            torch.clamp(_ceildiv(eps, self.alpha), min=1), eps))
        enter = done & alive
        F = torch.where(enter[:, None, None], torch.zeros_like(new.F), new.F)
        p_x = torch.where(enter[:, None],
                          self._reprice_x(c, eps_next, new.p_y, fixed),
                          new.p_x)
        return new._replace(eps=eps_next, k=self._int(torch.where(done, 0, k)),
                            alive=alive, F=F, p_x=p_x, fixed=fixed)

    def solve(self, w, *, cycle_budget: int | None = None) -> AssignAnswer:
        """Max-weight perfect matching of each ``(n, n)`` integer matrix of
        the batch ``w`` ``(B, n, n)``, on its device. ``cycle_budget``
        stops the loop after that many cycles (for the control, which
        need not converge)."""
        B, n, _ = w.shape
        dev = w.device
        wi = self._int(bonus_shift(w))
        c = self._int(-(n + 1) * wi)
        big = torch.clamp(torch.amax(torch.abs(c), dim=(-2, -1)), min=1)
        eps = self._int(torch.clamp(_ceildiv(big, self.alpha), min=1))
        zeros = torch.zeros((B, n), dtype=self.dt, device=dev)
        fixed = torch.zeros((B, n, n), dtype=torch.bool, device=dev)
        s = _State(eps=eps, k=torch.zeros(B, dtype=self.dt, device=dev),
                   alive=torch.ones(B, dtype=torch.bool, device=dev),
                   F=torch.zeros((B, n, n), dtype=self.dt, device=dev),
                   p_x=self._reprice_x(c, eps, zeros, fixed), p_y=zeros,
                   fixed=fixed,
                   rounds=torch.zeros(B, dtype=torch.int32, device=dev))
        cycles = 0
        while bool(s.alive.any()):
            if cycle_budget is not None and cycles >= cycle_budget:
                break
            s = _select(s.alive, self._cycle(c, s), s)
            cycles += 1
        matched = s.F.sum(-1) > 0
        col = torch.where(matched, torch.argmax(s.F, dim=-1), n)
        return AssignAnswer(col_of_row=col, weight=matching_weight(w, col),
                            rounds=s.rounds, converged=_perfect(s.F))


def bonus_shift(w):
    """``w`` plus the batch front end's uniform bonus ``1 - min(0, min
    w)`` per instance: the front end pads every matrix so that real arcs
    beat the zero-weight padding, which moves no optimum but is the input
    the solver's rounds run on."""
    low = torch.clamp(w.long().amin((-2, -1)), max=0)
    return w.long() + (1 - low)[:, None, None]


def _select(mask, new: _State, old: _State) -> _State:
    """Per instance, ``new`` where ``mask`` holds, else ``old``."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return _State(*(pick(a, b) for a, b in zip(new, old)))


def matching_weight(w, col):
    """Total weight, int64, of the rows' columns ``col`` ``(B, n)`` on
    ``w`` ``(B, n, n)``; a row whose column is out of range adds 0."""
    n = w.shape[-1]
    col = col.long()
    ok = (col >= 0) & (col < n)
    picked = torch.gather(w.long(), -1, col.clamp(0, n - 1).unsqueeze(-1))
    return torch.where(ok, picked.squeeze(-1), 0).sum(-1)


def is_permutation(col, n: int):
    """Per instance: every row has a column in ``[0, n)``, all distinct."""
    col = col.long()
    ok = ((col >= 0) & (col < n)).all(-1)
    hits = torch.zeros(col.shape, dtype=torch.int64, device=col.device)
    hits.scatter_add_(-1, col.clamp(0, n - 1), torch.ones_like(col))
    return ok & (hits == 1).all(-1)


def optimal(w, col):
    """Per instance: is the perfect matching ``col`` of maximum weight?

    Moving row x onto the column of row x' (whose row then moves on)
    changes the weight by ``w(x, M(x')) - w(x', M(x'))``; the matching is
    optimal exactly when no cycle of such moves has a positive sum, that
    is when ``C(x, x') = w(x', M(x')) - w(x, M(x'))`` has no negative
    cycle. Bellman–Ford from every node at once: distances that still fall
    after ``n`` passes lie on one. ``col`` must be a permutation.
    """
    B, n, _ = w.shape
    wl = w.long()
    cols = col.long().clamp(0, n - 1)
    at = torch.gather(wl, -1, cols.unsqueeze(-2).expand(B, n, n))
    own = torch.gather(wl, -1, cols.unsqueeze(-1)).squeeze(-1)
    C = own.unsqueeze(-2) - at              # C[b, x, x']
    dist = torch.zeros((B, n), dtype=torch.int64, device=w.device)
    for sweep in range(1, n + 2):
        nd = torch.minimum(dist, (dist.unsqueeze(-1) + C).amin(-2))
        if sweep % 16 == 0 and not bool((nd != dist).any()):
            break
        if sweep == n + 1:
            return (nd == dist).all(-1)
        dist = nd
    return torch.ones(B, dtype=torch.bool, device=w.device)
