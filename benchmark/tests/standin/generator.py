"""The stand-in's requests: ``cuts_per_request`` fresh cuts of the pool's
recordings, each of a length and offset drawn from the seed, written as
WAVs into the request's folder before its clock starts (after a pause of
``prepare_s``, so that preparation would show in any time it leaked
into)."""
from __future__ import annotations

import time

from benchmark import traffic


class Cuts:
    def __init__(self, mix: dict, pool, seed: int):
        self.mix = mix
        self.pool = pool
        self.seed = seed
        self.sample_rate = pool.sample_rate
        self.seen: set = set()

    def _cut(self, g) -> dict:
        while True:
            name = self.pool.recordings[int(g.integers(
                len(self.pool.recordings)))]
            lo, hi = self.mix["cut_ms"]
            n = int(g.integers(lo, hi + 1)) * self.sample_rate // 1000
            total = len(self.pool.samples(name))
            cut = {"recording": name, "samples": min(n, total),
                   "offset": int(g.integers(0, max(1, total - n + 1)))}
            key = tuple(sorted(cut.items()))
            if key not in self.seen:
                self.seen.add(key)
                return cut

    def _request(self, g) -> list:
        return [self._cut(g) for _ in range(self.mix["cuts_per_request"])]

    def warmup(self) -> list:
        g = traffic.rng(self.seed, traffic.WARMUP)
        return [self._request(g) for _ in range(self.mix["warmup_requests"])]

    def window(self):
        g = traffic.rng(self.seed, traffic.WINDOW)
        while True:
            yield self._request(g)

    def prepare(self, request: list, paths: list) -> None:
        from scipy.io import wavfile

        time.sleep(self.mix["prepare_s"])
        for cut, p in zip(request, paths):
            x = self.pool.samples(cut["recording"])
            wavfile.write(p, self.sample_rate,
                          x[cut["offset"]:cut["offset"] + cut["samples"]])


def generator(mix: dict, pool, seed: int) -> Cuts:
    return Cuts(mix, pool, seed)
