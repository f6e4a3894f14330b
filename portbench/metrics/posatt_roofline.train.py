"""The summed roofline bound of a training step's position attention ops
on a fixed mesh (forward, dscale, du) over the device time of the kernels
that compute them (#1, #3, #4), %."""

from portbench.readers import roofline

KERNELS = (
    "(anonymous namespace)::fwd_kernel<",  # #1
    "(anonymous namespace)::bwd_kernel<",  # #3, #4
)


def read(w):
    return roofline(w, KERNELS)
