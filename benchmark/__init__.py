"""The benchmark of c3sc_tpu_torch: harness, reference, roofline counts."""
