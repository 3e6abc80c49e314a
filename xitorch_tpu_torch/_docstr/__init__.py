from xitorch_tpu_torch._docstr.api_docstr import get_methods_docstr  # noqa: F401
