"""Traffic kind ``uniform_awgn``: frames filled to capacity, their
constellations drawn uniformly over ``constellations``, under AWGN of a
fixed ``noise_voltage`` (E|n|^2 = v^2), as the loopback sweep's noise
source sets it.

A mix's keys: ``kind``, ``frames_per_step``, ``constellations``,
``noise_voltage``."""

from modem_bench import generator


def make(mix: dict, m, seed: int, device) -> list:
    gen = generator.rng(seed, device)
    out = []
    for _ in range(generator.RING):
        clean, sent = generator.frames(mix, m, gen, device)
        out.append(sent._replace(samples=generator.awgn(clean, float(mix["noise_voltage"]), gen)))
        del clean, sent
    return out
