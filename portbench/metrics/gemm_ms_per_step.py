"""Device time of the library matrix products (kernel names holding one of
``trace.GEMM_NAMES``) per unit of work of the traced window (a training
step), ms."""

from portbench.readers import has_device, per_unit


def read(w):
    if not has_device(w):
        return None
    gemms = w.trace.gemms()
    return per_unit(w, w.trace.seconds(gemms)) if gemms else None
