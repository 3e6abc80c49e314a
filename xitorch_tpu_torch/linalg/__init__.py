from xitorch_tpu_torch.linalg.solve import solve  # noqa: F401
