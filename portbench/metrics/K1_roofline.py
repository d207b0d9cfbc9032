"""K1_roofline: percent of its roofline that K1 (``grid_push_decide``) reaches on the
timed path: each input byte read once and each output byte written once,
at the card's published rates, over the device time of its launches in
the traced segment (``peaks.kernel_roofline``)."""
from portbench.peaks import kernel_roofline


def read(run):
    return kernel_roofline(run, "K1")
