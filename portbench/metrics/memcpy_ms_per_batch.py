"""Device time of host<->device copies per unit of work of the traced
window (a device batch of ``Predictor.predict_array``), ms."""

from portbench.readers import has_device, per_unit


def read(w):
    if not has_device(w):
        return None
    copies = w.trace.memcpys()
    return per_unit(w, w.trace.seconds(copies)) if copies else None
