"""Device plane of the port: policy compilation, host encode and the
PyTorch batch program (see the package docstring)."""
