"""The length deck and the requests drawn from a seed."""

import math
import statistics

import pytest
import torch

from lds_bench import manifest, traffic
from lds_bench.reference.acoustic import bucket
from lds_bench.tests import tiny


FRAMES_PER_S = 44100 / 512


@pytest.mark.parametrize("name,n", [("solo", 16), ("b32", 8)])
def test_deck_is_the_lognormal_quantiles(name, n):
    t = manifest.traffic(name)
    lengths = t["lengths"]
    d = traffic.deck(t)
    assert len(d) == n and d == sorted(d)
    assert min(d) >= lengths["min_frames"] and max(d) == lengths["max_frames"]
    z = statistics.NormalDist().inv_cdf(0.5 / n)
    assert d[0] == round(lengths["median_frames"] * math.exp(lengths["sigma"] * z))
    assert abs(statistics.median(d) - lengths["median_frames"]) < 40


@pytest.mark.parametrize("name", ["solo", "b32"])
def test_lengths_fit_the_published_corpus(name):
    """The log-normal follows from its source's published statistics:
    clipped to the corpus's shortest and longest clip, its mean is the
    corpus's mean and its 1/(clips + 1) quantile the shortest clip; the
    deck's mean is the corpus's too."""
    t = manifest.traffic(name)
    src, lengths = t["source"], t["lengths"]
    voc = manifest.config("flagship")["vocoder"]
    assert voc["sampling_rate"] / math.prod(voc["upsample_rates"]) == FRAMES_PER_S
    assert lengths["min_frames"] == round(src["min_s"] * FRAMES_PER_S)
    assert lengths["max_frames"] == round(src["max_s"] * FRAMES_PER_S)
    law = statistics.NormalDist(math.log(lengths["median_frames"]), lengths["sigma"])
    n = 20000
    clipped = [min(max(math.exp(law.inv_cdf((i + 0.5) / n)), lengths["min_frames"]), lengths["max_frames"])
               for i in range(n)]
    assert statistics.mean(clipped) / FRAMES_PER_S == pytest.approx(src["mean_s"], rel=0.01)
    assert math.exp(law.inv_cdf(1 / (src["clips"] + 1))) / FRAMES_PER_S == pytest.approx(src["min_s"], rel=0.02)
    assert statistics.mean(traffic.deck(t)) / FRAMES_PER_S == pytest.approx(src["mean_s"], rel=0.02)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_every_seed_deals_the_same_lengths(seed):
    t = manifest.traffic("solo")
    dealt = traffic.order(t, seed)
    assert sorted(dealt) == traffic.deck(t)


def test_requests_repeat_from_the_seed():
    cfg, t = tiny.config("general"), tiny.traffic("b32")

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        book = torch.randn((cfg["codebook_size"], cfg["input_channel"]), generator=gen)
        return traffic.requests(t, cfg, seed, book, gen)

    a, b, c = draw(5), draw(5), draw(6)
    assert [r.frames for r in a] == [r.frames for r in b]
    assert all(torch.equal(x.units, y.units) and torch.equal(x.x_init, y.x_init) for x, y in zip(a, b))
    assert not torch.equal(a[0].x_init, c[0].x_init)
    for r in a:
        assert r.units.shape == (t["batch"], r.frames, cfg["input_channel"])
        assert r.x_init.shape == (t["batch"], bucket(r.frames), cfg["out_dims"])
        assert r.spk.min() >= 1 and r.spk.max() <= cfg["n_spk"]


@pytest.mark.parametrize("name", ["solo", "b32"])
@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 11])
def test_any_stretch_of_a_cycle_covers_the_distribution(name, seed):
    """The calls a window ends in, part of a cycle, hold short and long
    lengths alike: every half-cycle stretch of consecutive calls averages
    within 15% of the deck."""
    t = manifest.traffic(name)
    dealt = traffic.order(t, seed) * 2
    n = len(traffic.deck(t))
    mean = statistics.mean(traffic.deck(t))
    for start in range(n):
        part = dealt[start:start + n // 2]
        assert abs(statistics.mean(part) - mean) < 0.15 * mean
