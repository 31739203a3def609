"""The model step's share of the card's bf16 peak over the whole window,
in percent: the model FLOPs of every prompt prefilled and every token
decoded inside it (``portbench/yardstick.py::model_flops``, real rows
only) over the window's seconds at 989 TFLOP/s."""

from portbench.yardstick import BF16_FLOPS_PER_S


def read(rec):
    if rec.entry != "engine":
        return None
    w0, w1 = rec.window
    flops = rec.flops_in(w0, w1)
    return 100.0 * flops / (rec.seconds * BF16_FLOPS_PER_S) if flops else None
