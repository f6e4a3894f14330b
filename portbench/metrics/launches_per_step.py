"""Every kernel the traced window launched (the port's, cuBLAS,
elementwise, optimizer) per unit of work (a training step): an exact count
of the host's dispatch."""

from portbench.readers import has_device


def read(w):
    if not has_device(w) or w.units <= 0:
        return None
    return len(w.trace.kernels()) / w.units
