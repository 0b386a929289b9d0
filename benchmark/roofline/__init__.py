"""Roofline counts: the chip's published peaks and the operations and bytes
of each kernel, counted from a configuration's shapes alone."""
