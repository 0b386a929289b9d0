"""The planar 6D quadcopter (Gorodetsky, Karaman, Marzouk, IJRR 2018)."""

from benchmark.reference.quadcopter import Quadcopter


def reference(cfg: dict) -> Quadcopter:
    return Quadcopter.from_config(cfg)


def program(cfg: dict):
    from c3sc_tpu_torch.models.quadcopter import make_quadcopter_problem

    return make_quadcopter_problem(**cfg["problem"])
