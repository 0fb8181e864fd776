"""spmv_roofline: the least time of the traced window's sparse
products over the device time of the kernels that ran them, in percent.

The least time is the bytes each product has to move, reckoned from the
benchmark's own CSR (``eigbench/reference/roofline.py``: each stored value
and column index once, ``x`` once in the storage dtype, ``y`` once in the
compute dtype), times ``num_iters`` products a solve, over the card's
published bandwidth.  The device time is the sum over the profiler's
kernels that ``spmv_roofline.json`` lists.  None without a device
trace, without a listed kernel in it, or on a card the table of peaks
lacks.
"""

import json
import os

from eigbench.reference.roofline import least_seconds, spmv_bytes

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "spmv_roofline.json")) as f:
    KERNELS = tuple(json.load(f)["kernels"])


def read(ctx):
    trc = ctx["trace"]
    if trc is None or ctx["traced_solves"] <= 0:
        return None
    device_s = trc.device_us(KERNELS) / 1e6
    if device_s <= 0:
        return None
    p = ctx["traffic"]["precision"]
    per = spmv_bytes(ctx["n"], ctx["nnz"], p["storage"], p["storage"], p["compute"])
    products = ctx["traffic"]["num_iters"] * ctx["traced_solves"]
    least = least_seconds(per * products, ctx["device"]["kind"])
    return None if least is None else 100.0 * least / device_s
