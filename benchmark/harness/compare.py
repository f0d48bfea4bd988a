"""The comparison that decides `correct`: one call of the window, drawn from
the seed, replayed by the plain reference from the same film and key, and
the program's film after that call held against the reference's.

The numbers compared, each against the workload's `limits`:
  * `frame_gap`: |program's frame count - reference's| after the call
    (exact: limit 0);
  * `key_gap`: 1 if the program's key for the next frame differs from the
    reference's key chain at that frame, else 0 (exact: limit 0);
  * `film_gap`: the widest gap of any pixel channel between the two films
    after the call, in units of that call's share of the film, relative to
    the reference's value (with a floor of FLOOR times the image's mean):
        |after - expected| * (F + n) / n / max(|expected|, FLOOR * mean|expected|)
    for a call of n frames that ends on frame F + n.  A call's frames
    enter the running mean with weight n / (F + n), so the factor
    undoes that dilution: a wrong frame reads the same late in the
    window as early.
"""

import random

import torch

FLOOR = 0.01


class Sampler:
    """Keeps one call of the window, uniform over all calls that complete,
    drawn from the seed (reservoir sampling): (film before, film after, n)."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept = None

    def offer(self, before, after, n: int):
        self.seen += 1
        if self.rng.randrange(self.seen) == 0:
            self.kept = (before, after, n)


def film_gap(after_hdr, expected_hdr, frame_after: int, n: int) -> float:
    """The `film_gap` of two films (see the module's docstring)."""
    a = after_hdr.double()
    x = expected_hdr.to(a.device).double()
    denom = torch.clamp(x.abs(), min=FLOOR * float(x.abs().mean()) + 1e-30)
    return float(((a - x).abs() / denom).max()) * frame_after / n


def compare(kept, replay, limits: dict) -> dict:
    """{name: (value, limit)} of the kept call against the reference's
    replay(hdr, frame, n) -> (film, overflow) of the same call."""
    before, after, n = kept
    expected, _ = replay(before.hdr, before.frame, n)
    key_gap = 0 if torch.equal(after.key.cpu(), expected.key.cpu()) else 1
    checks = {
        "frame_gap": (abs(after.frame - expected.frame), 0),
        "key_gap": (key_gap, 0),
        "film_gap": (film_gap(after.hdr, expected.hdr, expected.frame, n),
                     limits["film_gap"]),
    }
    return checks


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
