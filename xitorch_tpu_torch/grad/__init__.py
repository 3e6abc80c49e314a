from xitorch_tpu_torch.grad.jachess import jac, hess  # noqa: F401
