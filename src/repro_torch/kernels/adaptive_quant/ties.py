"""Rows at rounding ties, to hold the ``adaptive_quant`` kernel to its plain
version where its quotient rule is weakest.

The kernel rounds fl((clip(x) - lo) * fl(1/s)) where the plain version
rounds fl((clip(x) - lo) / s), and divides only inside a window about each
half-integer (``csrc/adaptive_quant.cu``). :func:`tie_rows` moves a row's
values so that the plain version's quotients land on half-integers and one
f32 ulp either side: the even columns for the range the plain version's
search chooses (so the final codes meet the ties), the odd columns for the
row's full range (the search's first candidate). :func:`tie_share` says how
many of a row set's final quotients lie at such a tie.
"""

from __future__ import annotations

import torch

from ...core.quantize import adaptive_quantize, recip32

_ULPS = 4  # how far from the nearest f32 a value is searched for


def _full_range(x: torch.Tensor, levels: int):
    """(lo, s) of each row's full range, as the search's first candidate."""
    mn, mx = x.amin(dim=1), x.amax(dim=1)
    rng = mx - mn
    s = torch.where(rng > 0, rng * recip32(levels, x), torch.ones_like(rng))
    return mn, s


def _steps(v: torch.Tensor, n: int, toward: float):
    out = [v]
    for _ in range(n):
        out.append(torch.nextafter(out[-1], torch.full_like(v, toward)))
    return out[1:]


def tie_rows(x: torch.Tensor, bits: int, num_bins: int = 25, ratio: float = 0.5,
             near: float = 0.1, rounds: int = 4, seed: int = 0) -> torch.Tensor:
    """A copy of ``x`` (rows, dim) f32 in which each value whose quotient
    (x - lo) / s lies within ``near`` of a half-integer k + 1/2, under the
    range the plain version chooses for the row (even columns) or under
    the row's full range (odd columns), is moved to where that quotient is
    k + 1/2 in f32 or one ulp from it (chosen at random). A row's minimum
    and maximum stay. Moving values can change the chosen range: a row is
    moved again, up to ``rounds`` times, until the range it was moved for
    is the one chosen; rows that never settle keep their last move."""
    x = x.to(torch.float32).clone()
    rows, dim = x.shape
    levels = (1 << bits) - 1
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    side = torch.randint(-1, 2, (rows, dim), generator=gen, device=x.device)
    to_chosen = (torch.arange(dim, device=x.device) % 2 == 0)[None, :]
    at = torch.arange(rows, device=x.device)
    chosen = adaptive_quantize(x, bits, num_bins, ratio)
    settled = torch.zeros(rows, dtype=torch.bool, device=x.device)
    for _ in range(rounds):
        f_lo, f_s = _full_range(x, levels)
        lo = torch.where(to_chosen, chosen.zero[:, None], f_lo[:, None])
        s = torch.where(to_chosen, chosen.scale[:, None], f_s[:, None])
        t = (x - lo) / s
        k = torch.floor(t)
        movable = (((t - k - 0.5).abs() < near) & (k >= 0) & (k < levels)
                   & ~settled[:, None] & (f_s > 0)[:, None])
        movable[at, x.argmin(dim=1)] = False
        movable[at, x.argmax(dim=1)] = False
        target = k + 0.5
        big = torch.full_like(target, 1e9)
        target = torch.where(side > 0, torch.nextafter(target, big), torch.where(
            side < 0, torch.nextafter(target, -big), target))
        v0 = (lo.double() + target.double() * s.double()).to(torch.float32)
        best, found = v0.clone(), (v0 - lo) / s == target
        for up, down in zip(_steps(v0, _ULPS, 3e38), _steps(v0, _ULPS, -3e38)):
            for cand in (up, down):
                hit = ((cand - lo) / s == target) & ~found
                best = torch.where(hit, cand, best)
                found |= hit
        x = torch.where(movable, best, x)
        again = adaptive_quantize(x, bits, num_bins, ratio)
        settled |= (again.zero == chosen.zero) & (again.scale == chosen.scale)
        chosen = again
    return x


def tie_share(x: torch.Tensor, bits: int, num_bins: int = 25,
              ratio: float = 0.5) -> float:
    """The share of values whose quotient under the range the plain version
    chooses is a half-integer or one f32 ulp from one."""
    q = adaptive_quantize(x, bits, num_bins, ratio)
    lo, s = q.zero[:, None], q.scale[:, None]
    t = (torch.maximum(x, lo) - lo) / s
    half = torch.floor(t) + 0.5
    inf = torch.full_like(t, 3e38)
    at = ((t == half) | (torch.nextafter(t, inf) == half)
          | (torch.nextafter(t, -inf) == half)) & (t < (1 << bits) - 1)
    return float(at.float().mean())
