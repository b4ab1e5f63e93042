"""K3's share of its roofline over the window: each step's least time
(``bounds.k3_bound_s``, compressed mode) over the device time of K3's four
kernels in it. Layer: kernels."""

from portbench import readers


def read(ctx):
    if ctx["loop"] != "train":
        return None
    return readers.kernel_share(ctx, "step", readers.K3, "coo_backward_kernel", "k3_bound_s")
