"""Per-system drivers mirroring the reference's ``c3sc/examples/<system>/``
layout (SURVEY.md §2.1): each wraps the registry CLI
(``python -m c3sc_tpu_torch.cli``) for its system, and flags pass through:

    python -m c3sc_tpu_torch.examples.pendulum --rollouts 256 --plot
    python -m c3sc_tpu_torch.examples.quadcopter --n 31 --rmax 20 --max-iters 2000
"""
