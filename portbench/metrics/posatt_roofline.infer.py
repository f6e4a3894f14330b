"""The summed roofline bound of an inference batch's position attention
forwards over the device time of the kernels that compute them (#1), %."""

from portbench.readers import roofline

KERNELS = ("(anonymous namespace)::fwd_kernel<",)


def read(w):
    return roofline(w, KERNELS)
