from xitorch_tpu_torch.optimize.rootfinder import rootfinder, equilibrium, minimize  # noqa: F401
