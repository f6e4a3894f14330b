"""The summed roofline bound of a training step's point-cloud position
attention ops (forward, dscale, dv) over the device time of the kernels
that compute them (#11, #12 and #12's dscale partial sums), %."""

from portbench.readers import roofline

KERNELS = (
    "(anonymous namespace)::tf_kernel<",  # #11
    "(anonymous namespace)::tf_bwd_kernel<",  # #12
    "(anonymous namespace)::sum_partials_kernel(",  # #12's dscale partial sums
)


def read(w):
    return roofline(w, KERNELS)
