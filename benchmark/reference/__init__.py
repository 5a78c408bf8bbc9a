r"""Plain PyTorch references of the benchmark's configurations.

Each module here is written from a published architecture and imports
neither JAX nor anything of the program under test. A reference computes in
float32 from the weights that the benchmark draws (stored in the served
dtype, widened where used), with TF32 off; :class:`common.Ops` can round the
operands of its products to a lower precision, which is the control that the
comparison must fail.
"""
