"""The share of the traced window in which no operation ran on the
device, %."""

from portbench.readers import idle


def read(w):
    return idle(w)
