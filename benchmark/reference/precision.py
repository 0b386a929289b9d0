"""Matrix products of the reference at a stated precision: float64 for the
reference itself, and for the controls float32 products whose inputs are
rounded to TF32 (a 10-bit mantissa, as the tensor cores read float32 when
TF32 is allowed), accumulated in float32."""

import torch


def tf32(x):
    """x (float32) rounded to the nearest TF32 value, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def bmm(a, b, tf32_products: bool = False):
    """torch.bmm, with TF32-rounded inputs where asked (float32 inputs)."""
    if tf32_products:
        a, b = tf32(a), tf32(b)
    return torch.bmm(a, b)
