"""Traffic kind ``snr_calibrated``: frames filled to capacity, their
constellations drawn uniformly over ``constellations``, under AWGN at
``snr_db`` against the measured mean power of each stream's clean frames
(the SNR a link's rung threshold is stated in).

A mix's keys: ``kind``, ``frames_per_step``, ``constellations``,
``snr_db``."""

from modem_bench import generator


def make(mix: dict, m, seed: int, device) -> list:
    gen = generator.rng(seed, device)
    out = []
    for _ in range(generator.RING):
        clean, sent = generator.frames(mix, m, gen, device)
        v = generator.snr_voltage(clean, float(mix["snr_db"]))
        out.append(sent._replace(samples=generator.awgn(clean, v, gen)))
        del clean, sent
    return out
