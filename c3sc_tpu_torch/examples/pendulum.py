"""pendulum example: a thin wrapper over the registry CLI (reference analogue:
c3sc/examples/pendulum main.c; SURVEY.md §2.1).

    python -m c3sc_tpu_torch.examples.pendulum [CLI flags]
"""

import sys

from c3sc_tpu_torch import cli


def main(argv=None):
    return cli.main(["pendulum"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
