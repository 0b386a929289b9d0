"""One file a model, found by the configuration's ``model``: each gives
``reference(cfg)``, the plain reference's model at the configuration's
constants (``benchmark/reference/``), and ``program(cfg)``, the program's
problem made by its own factory from the same constants. The reference's
model carries what the checks and the rooflines read of the model's shape:
``dx``, ``du``, ``dw``, ``lb``, ``ub``, ``boundary`` and ``candidates``."""
