"""The benchmark's plain reference modem: a frozen copy, in plain PyTorch
and numpy, of the batch modem's transmitter and receiver (framing, CRCs,
header, repack, constellations, OFDM, channel estimate, the
decision-directed equalizer as a loop over symbols, LDPC encode and
sum-product BP as a loop over iterations).

It imports nothing of the program under test and takes nothing the
program made: the benchmark makes its traffic with :mod:`.modem`'s
transmitter and judges the program's outputs against :mod:`.modem`'s
receiver run on the same samples.  It runs on any device; on a card it
takes no hand-written kernel.
"""
